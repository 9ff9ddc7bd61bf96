#!/usr/bin/env python
"""Benchmark driver.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

HEADLINE: end-to-end throughput (align + type) on a REAL-PRG-SCALE package —
3M graph levels, 8 haplotypes, ~30k read pairs — the scale of
PRG_MHC_GRCh38_withIMGT (VERDICT r1 item 3: the real workload, not a toy
graph).  The package is cached in .bench_cache/ between runs.

Baseline: the reference C++ aligner's serial alignOneReadPair loop processes
on the order of 400 read pairs/s (~800 reads/s) on a 7-core workstation.
NOTE this baseline is an ESTIMATE — the reference prints "protoSeeds (read
pairs) per s" at runtime (processBAM.cpp:1894-1898) but publishes no stored
number, and the C++ tree does not build in this environment (no BamTools/
Boost); replace with a measured number when a side-by-side run is possible.

Secondary diagnostics on stderr: the device line, small-graph alignment
throughput, truth accuracy.
"""

import json
import os
import pickle
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 800.0
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
N_LEVELS = 3_000_000

# Measurement window (printed into the JSON so the recorded artifact is
# self-describing): N full-size warmup passes excluded, then the median
# over the measured passes.  Warmups are FULL-SIZE — BENCH_r04's first
# "measured" rep was 3.83s vs a 2.4-2.7s steady state because the only
# prior pass was 64 pairs.
ALIGN_WARMUP, ALIGN_REPS = 2, 5
TYPE_WARMUP, TYPE_REPS = 2, 5


def _cpu_now() -> float:
    """Process CPU seconds, self + reaped children (utime+stime).
    NOTE: persistent worker-pool children only contribute after they are
    reaped, so for the parallel path this mostly audits the PARENT's
    work per rep; wall remains the throughput number."""
    import resource
    a = resource.getrusage(resource.RUSAGE_SELF)
    b = resource.getrusage(resource.RUSAGE_CHILDREN)
    return a.ru_utime + a.ru_stime + b.ru_utime + b.ru_stime


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def build_real_scale_cache():
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator
    os.makedirs(CACHE, exist_ok=True)
    rng = np.random.default_rng(31337)
    t0 = time.time()
    sim = simulate_prg_package(
        rng, backbone_length=N_LEVELS, n_haplotypes=8, snp_rate=0.01,
        genes={"A": (0.30, 0.31), "B": (0.60, 0.61)})
    log(f"real-scale sim built in {time.time() - t0:.0f}s")
    if not os.path.exists(os.path.join(CACHE, "pkg", "sequences.txt")):
        t0 = time.time()
        sim.write_package(os.path.join(CACHE, "pkg"))
        log(f"package written+compiled in {time.time() - t0:.0f}s")
    rs = ReadSimulator(rng, read_length=101, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    truth = {}
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 1.0,
                                               name_prefix=f"h{h}")
    with open(os.path.join(CACHE, "pairs.pkl"), "wb") as fh:
        pickle.dump([((p.r1.name, p.r1.seq, p.r1.qual),
                      (p.r2.name, p.r2.seq, p.r2.qual)) for p in pairs], fh)
    truth = {}
    for p in pairs:
        truth[p.r1.name + "/1"] = p.r1.levels
        truth[p.r2.name + "/2"] = p.r2.levels
    with open(os.path.join(CACHE, "truth.pkl"), "wb") as fh:
        pickle.dump(truth, fh)


def real_scale_bench():
    from hla_la_tpu.io.fastq import FastqRead
    from hla_la_tpu.models.parallel_host import ParallelAligner, spawn_safe
    from hla_la_tpu.models.aligner import ReadAligner
    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.sim.truth import TrueReadLevels

    if not os.path.exists(os.path.join(CACHE, "pairs.pkl")):
        log("building real-scale package (cold, ~5 min; cached for "
            "later runs)")
        build_real_scale_cache()
    fq_raw = pickle.load(open(os.path.join(CACHE, "pairs.pkl"), "rb"))
    fq = [(FastqRead(*a), FastqRead(*b)) for a, b in fq_raw]
    truth = TrueReadLevels(pickle.load(
        open(os.path.join(CACHE, "truth.pkl"), "rb")))
    log(f"real-scale: {N_LEVELS} levels, {len(fq)} read pairs")

    n_workers = min(os.cpu_count() or 1, 8)
    pkg_dir = os.path.join(CACHE, "pkg")
    if n_workers > 1 and spawn_safe():
        engine = ParallelAligner(pkg_dir, n_workers)
        log(f"{n_workers} host worker processes")
    else:
        engine = ReadAligner(GraphPackage(pkg_dir))
    t0 = time.time()
    engine.align_pairs(fq[:64], 113, 27)
    log(f"worker init/warmup: {time.time() - t0:.1f}s")

    # Measurement window (VERDICT r4 weak #1: the recorded median must
    # not contain warmup ramp): ALIGN_WARMUP full-size passes are run
    # and EXCLUDED, then ALIGN_REPS passes are measured; the headline is
    # the median of the measured reps (best-of kept as secondary — the
    # VM is 2x noisy).  Per-rep process-CPU time (self+children
    # utime+stime) is logged alongside wall so captures are auditable.
    align_reps, align_cpu = [], []
    aligned = []
    for rep in range(ALIGN_WARMUP + ALIGN_REPS):
        warm = rep < ALIGN_WARMUP
        t0, c0 = time.time(), _cpu_now()
        aligned = engine.align_pairs(fq, 113, 27,
                                     truth=truth if rep == 0 else None)
        dt, dc = time.time() - t0, _cpu_now() - c0
        log(f"align rep {rep}{' (warmup, excluded)' if warm else ''}: "
            f"{dt:.2f}s wall / {dc:.2f}s cpu = {2 * len(fq) / dt:.0f} "
            f"reads/s")
        if not warm:
            align_reps.append(dt)
            align_cpu.append(dc)
    med_align = float(np.median(align_reps))
    best_align = min(align_reps)
    n_reads = 2 * len(fq)
    log(f"aligned {len(aligned)}/{len(fq)} pairs, truth accuracy "
        f"{truth.accuracy():.4f}")

    # typing on the aligned output (full e2e = align + type)
    from hla_la_tpu.models.typer import HLATyper
    import tempfile
    pkg = GraphPackage(pkg_dir)
    typer = HLATyper(pkg)
    pool = engine if isinstance(engine, ParallelAligner) else None
    aligned_ids = (set(aligned.read_ids) if hasattr(aligned, "read_ids")
                   else {ap.read_id for ap in aligned})
    kept_fq = [p for p in fq if p[0].name in aligned_ids]
    type_reps, type_cpu, res = [], [], None
    for rep in range(TYPE_WARMUP + TYPE_REPS):
        warm = rep < TYPE_WARMUP
        t0, c0 = time.time(), _cpu_now()
        with tempfile.TemporaryDirectory() as td:
            res = typer.type_all(kept_fq, aligned, [], [], 113.0, 27.0, td,
                                 n_workers=min(n_workers, 4),
                                 worker_pool=pool)
        dt, dc = time.time() - t0, _cpu_now() - c0
        log(f"type rep {rep}{' (warmup, excluded)' if warm else ''}: "
            f"{dt:.2f}s wall / {dc:.2f}s cpu")
        if not warm:
            type_reps.append(dt)
            type_cpu.append(dc)
    med_type = float(np.median(type_reps))
    best_type = min(type_reps)
    calls = {r.locus: (r.allele1_id, r.allele2_id) for r in res}
    log(f"typing: median {med_type:.1f}s / best {best_type:.1f}s, "
        f"calls {calls}")
    # correctness gates: perf numbers are meaningless for a broken pipeline
    assert truth.accuracy() > 0.95, \
        f"alignment truth accuracy regressed: {truth.accuracy():.4f}"
    for locus in ("A", "B"):
        want = {f"{locus}*02:01", f"{locus}*03:01"}
        assert set(calls.get(locus, ())) == want, \
            f"typing regression at {locus}: {calls.get(locus)} != {want}"

    e2e = n_reads / (med_align + med_type)
    e2e_best = n_reads / (best_align + best_type)
    log(f"real-scale e2e: median {e2e:.0f} reads/s "
        f"(best-of-{len(align_reps)}: {e2e_best:.0f})")
    log(f"real-scale align-only: median {n_reads / med_align:.0f} reads/s "
        f"(best {n_reads / best_align:.0f})")
    if hasattr(engine, "close"):
        engine.close()
    return {"e2e_median": e2e, "e2e_best": e2e_best,
            "align_reps_s": [round(x, 3) for x in align_reps],
            "align_cpu_s": [round(x, 3) for x in align_cpu],
            "type_reps_s": [round(x, 3) for x in type_reps],
            "type_cpu_s": [round(x, 3) for x in type_cpu],
            "n_reads": n_reads}


def toy_bench():
    """Secondary: the round-1 small-graph benchmark (stderr only)."""
    from hla_la_tpu.models.aligner import ReadAligner
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator
    import tempfile
    rng = np.random.default_rng(20260817)
    tmp = tempfile.mkdtemp(prefix="hla_bench_toy_")
    sim = simulate_prg_package(rng, backbone_length=6000, n_haplotypes=8,
                               snp_rate=0.01)
    pkg = sim.write_package(os.path.join(tmp, "pkg"))
    rs = ReadSimulator(rng, read_length=101, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 30.0,
                                               name_prefix=f"h{h}")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    eng = ReadAligner(pkg, use_jax=False)
    eng.align_pairs(fq[:64], 118, 35)
    best = None
    for _ in range(3):
        t0 = time.time()
        eng.align_pairs(fq, 118, 35)
        best = min(best or 1e9, time.time() - t0)
    log(f"toy graph (6k levels, serial): {2 * len(fq) / best:.0f} reads/s")


def main():
    t_start = time.time()
    from hla_la_tpu import device
    device.setup_compile_cache()
    log(device.device_line())
    log("baseline 800 reads/s is an ESTIMATE (reference publishes no "
        "number and does not build here)")

    stats = real_scale_bench()
    # the driver parses the LAST stdout JSON line.  value = MEDIAN of the
    # post-warmup reps; best-of + per-rep times are carried alongside
    print(json.dumps({
        "metric": "e2e_reads_per_sec_real_prg_scale",
        "value": round(stats["e2e_median"], 1),
        "unit": "reads/s",
        "vs_baseline": round(stats["e2e_median"] / BASELINE_READS_PER_SEC,
                             3),
        "median": round(stats["e2e_median"], 1),
        "best": round(stats["e2e_best"], 1),
        "window": (f"median of {ALIGN_REPS} measured reps after "
                   f"{ALIGN_WARMUP} full-size warmup reps (align) / "
                   f"{TYPE_WARMUP} (type), warmups excluded"),
        "reps": {"align_s": stats["align_reps_s"],
                 "align_cpu_s": stats["align_cpu_s"],
                 "type_s": stats["type_reps_s"],
                 "type_cpu_s": stats["type_cpu_s"],
                 "n_reads": stats["n_reads"]},
    }), flush=True)
    toy_bench()

    log(f"total bench time {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
