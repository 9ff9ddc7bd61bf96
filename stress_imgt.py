"""IMGT-scale typing stress: the reference's real typing working point.

The reference loads segment allele matrices with THOUSANDS of rows per
class-I locus, clusters them (HLATyper.cpp:1198-1372) and runs the C^2 pair
loop at C up to thousands (HLATyper.cpp:2280-2364) — SURVEY §7 risk (d):
C ~ 10^3-10^4 -> up to 10^8 pairs x read partials, "tile and stream".
Every suite/soak world runs at ~12 clusters; tests/test_imgt_scale.py locks
C ~ 560 in-suite.  This script is the full-scale version:

  - >= 2,200 distinct alleles per locus over class-I-sized exon segments
    (J = 540 columns = IMGT exons 2+3), post-clustering C >= 2,000;
  - platinum-beyond depth: R >= 10^4 reads per locus;
  - checks: exact calls on planted truth, bounded peak memory, the full
    C(C+1)/2 posterior dump, and C^2 reduction wall time on BOTH backends
    (numpy timed on a read-slice and extrapolated — it is linear in R;
    pass --full-numpy for the complete run).

Usage: python stress_imgt.py [--fresh] [--full-numpy] [--skip-kernels]
(--skip-kernels: skip the backend kernel-timing section — the numpy
extrapolation slice alone costs ~10 min on a contended VM)
Cache: /tmp/hla_imgt_stress_v1.  Not in the pytest suite (minutes);
run after invasive typer/pair_ll changes.
"""
import os
import pickle
import resource
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
if "--sharded" in sys.argv:
    # virtual 8-device CPU mesh for the sharded C^2 proof (must be set
    # before jax initialises)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()
import jax

jax.config.update("jax_platforms", "cpu")

CACHE = "/tmp/hla_imgt_stress_v1"
GENES = {"A": (0.10, 0.37), "B": (0.50, 0.77)}   # 1080 cols -> J=540 each
BACKBONE = 4000
N_ALLELES = 2200
TRUTH_HAPS = (1, 2)
if "--loci4" in sys.argv:
    # 4 class-I-sized loci at full IMGT depth: the production typing-worker
    # gate (>=50k aligned reads AND >=4 loci) engages WITHOUT overrides —
    # the regime the fan-out exists for (17 deep loci at WGS scale)
    CACHE = "/tmp/hla_imgt_stress_v1_4loci"
    BACKBONE = 8000
    GENES = {"A": (0.05, 0.185), "B": (0.29, 0.425),
             "C": (0.53, 0.665), "DQB1": (0.76, 0.895)}


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def build_cache():
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator

    os.makedirs(CACHE, exist_ok=True)
    rng = np.random.default_rng(161803)
    t0 = time.time()
    sim = simulate_prg_package(rng, backbone_length=BACKBONE, n_haplotypes=8,
                               snp_rate=0.01, genes=GENES,
                               n_gene_alleles=N_ALLELES,
                               allele_snp_rate=0.02)
    log(f"dense-DB sim ({N_ALLELES} alleles/locus) built in "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    sim.write_package(os.path.join(CACHE, "pkg"))
    log(f"package written+compiled in {time.time() - t0:.0f}s")

    # targeted ultra-deep reads over each gene window (exon-capture
    # analogue): per-locus R >= 10^4 without simulating the whole backbone
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=25, with_error=True)
    gene_windows = []
    for locus in GENES:
        cols = [i for i, n in enumerate(sim.column_names)
                if f"_gene_{locus}_" in n]
        gene_windows.append((min(cols) - 300, max(cols) + 300))
    pairs = []
    t0 = time.time()
    for h in TRUTH_HAPS:
        seq, levels = sim.linearized(h)
        for gi, (lo, hi) in enumerate(gene_windows):
            sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
            pairs += rs.simulate_pairs_from_string(
                seq[sel[0]:sel[-1] + 1], levels[sel[0]:sel[-1] + 1],
                1250.0, name_prefix=f"h{h}g{gi}")
    log(f"{len(pairs)} pairs simulated in {time.time() - t0:.0f}s")
    with open(os.path.join(CACHE, "pairs.pkl"), "wb") as fh:
        pickle.dump([((p.r1.name, p.r1.seq, p.r1.qual),
                      (p.r2.name, p.r2.seq, p.r2.qual)) for p in pairs], fh)


def time_pair_reduction(C: int, R: int, full_numpy: bool):
    """C^2 reduction wall time on both backends at the run's real shape.
    numpy is linear in R: timed on a slice and extrapolated unless
    --full-numpy."""
    from hla_la_tpu.ops.pair_ll import (pair_ll_reduction,
                                        pair_ll_reduction_numpy)
    rng = np.random.default_rng(5)
    L = rng.normal(-40.0, 8.0, (C, R)).astype(np.float64)

    from hla_la_tpu import native
    if native.available():
        t0 = time.time()
        out_native = native.pair_ll(L)
        t_nat = time.time() - t0
        log(f"pair reduction native (AVX-512): {t_nat:.1f}s "
            f"= {C * C * R / t_nat / 1e9:.2f} Gcells/s")

    t0 = time.time()
    out_jax = pair_ll_reduction(L, backend="jax")
    t_jax_cold = time.time() - t0
    t0 = time.time()
    out_jax = pair_ll_reduction(L, backend="jax")
    t_jax = time.time() - t0
    gcells = C * C * R / t_jax / 1e9
    log(f"pair reduction jax: {t_jax:.1f}s warm ({t_jax_cold:.1f}s cold) "
        f"= {gcells:.2f} Gcells/s at C={C}, R={R} "
        f"({C * (C + 1) // 2} pairs); peak RSS {rss_gb():.2f} GB")
    if native.available():
        assert np.allclose(out_native, out_jax, rtol=1e-6, atol=1e-2), \
            "native/jax pair-reduction mismatch at scale"

    r_slice = R if full_numpy else min(R, 512)
    t0 = time.time()
    out_np = pair_ll_reduction_numpy(L[:, :r_slice])
    t_np_slice = time.time() - t0
    t_np_est = t_np_slice * (R / r_slice)
    tag = "measured" if full_numpy else f"extrapolated from R={r_slice}"
    log(f"pair reduction numpy: {t_np_est:.0f}s ({tag}; "
        f"{C * C * r_slice / t_np_slice / 1e9:.3f} Gcells/s)")

    # parity between the backends on the timed slice
    out_jax_slice = pair_ll_reduction(L[:, :r_slice], backend="jax")
    assert np.allclose(out_jax_slice, out_np, rtol=1e-6, atol=1e-4), \
        "numpy/jax pair-reduction mismatch at scale"
    log("numpy/jax parity OK on the timed slice")
    return t_jax, t_np_est


def time_sharded_reduction(C: int, R: int):
    """VERDICT r4 next #2: the model-axis-sharded C^2 reduction
    (parallel/mesh.py::pair_ll_reduction_sharded — the distributed form of
    the reference's ONLY parallel loop, HLATyper.cpp:2280-2364) has never
    run at IMGT cluster counts.  Run it at this world's real (C, R) on the
    8-device virtual CPU mesh: parity vs the host kernels, bounded
    per-device memory, per-phase wall time."""
    import jax as _jax
    n_dev = len(_jax.devices())
    assert n_dev >= 8, f"need the 8-device virtual mesh, have {n_dev}"
    from hla_la_tpu import native
    from hla_la_tpu.ops.pair_ll import pair_ll_reduction
    from hla_la_tpu.parallel.mesh import pair_ll_reduction_sharded

    rng = np.random.default_rng(5)
    L = rng.normal(-40.0, 8.0, (C, R)).astype(np.float64)
    rss0 = rss_gb()

    t0 = time.time()
    out_sh = pair_ll_reduction_sharded(L)
    t_cold = time.time() - t0
    t0 = time.time()
    out_sh = pair_ll_reduction_sharded(L)
    t_warm = time.time() - t0
    gc = C * C * R / t_warm / 1e9
    # per-device tile bound from the mesh chunk formula (mesh.py):
    # [C/m, C, chunk] f32 with chunk = min(512, 1.3e8 // (C/m * Cp))
    m = 2
    cp = -(-C // m) * m
    chunk = min(512, max(1, int(1.3e8 // max((cp // m) * cp, 1))))
    tile_gb = (cp // m) * cp * chunk * 4 / 1e9
    log(f"sharded C^2 @ C={C}, R={R} on {n_dev}-dev virtual mesh: "
        f"{t_warm:.1f}s warm ({t_cold:.1f}s cold) = {gc:.2f} Gcells/s; "
        f"per-device scan tile {tile_gb:.2f} GB (chunk={chunk}); "
        f"peak RSS {rss_gb():.2f} GB (was {rss0:.2f})")

    # parity vs both host kernels at the full shape
    out_jax = pair_ll_reduction(L, backend="jax")
    d_jax = np.abs(out_sh - out_jax)
    rel_jax = d_jax / np.maximum(np.abs(out_jax), 1.0)
    assert np.allclose(out_sh, out_jax, rtol=1e-6, atol=1e-2), \
        f"sharded/jax mismatch: max abs {d_jax.max():.3g}"
    msg = (f"parity: |sharded-jax| max abs {d_jax.max():.3g} / "
           f"max rel {rel_jax.max():.3g}")
    if native.available():
        out_nat = native.pair_ll(L)
        d_nat = np.abs(out_sh - out_nat)
        assert np.allclose(out_sh, out_nat, rtol=1e-6, atol=1e-2), \
            f"sharded/native mismatch: max abs {d_nat.max():.3g}"
        msg += f"; |sharded-native(f64)| max abs {d_nat.max():.3g}"
    log(msg)
    # a virtual CPU mesh measures correctness and memory shape, not
    # speedup (its devices share the host's cores)
    log("context: virtual CPU mesh — the number above is a "
        "correctness/memory proof, not multi-device scaling")
    return t_warm


def run_long_mode():
    """--long: long-read typing semantics at IMGT cluster counts (VERDICT
    r4 weak #7 second half: the unpaired model, 0.075 typing indel rates
    and the high-coverage filters, HLATyper.cpp:938-947, had only ever
    run at toy C).  ONT-duplex-style ~2-3.5 kb unpaired reads over the
    C=2200 gene windows, production long-read alignment (auto band 256)
    + long-mode typing; asserts truth-cluster calls at both loci."""
    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.io.fastq import FastqRead
    from hla_la_tpu.models.parallel_host import ParallelAligner, spawn_safe
    from hla_la_tpu.models.typer import HLATyper
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator

    pkg_dir = os.path.join(CACHE, "pkg")
    cache_f = os.path.join(CACHE, "long_reads.pkl")
    if not os.path.exists(cache_f):
        rng = np.random.default_rng(161803)   # the world's own seed
        t0 = time.time()
        sim = simulate_prg_package(rng, backbone_length=BACKBONE,
                                   n_haplotypes=8, snp_rate=0.01,
                                   genes=GENES, n_gene_alleles=N_ALLELES,
                                   allele_snp_rate=0.02)
        log(f"sim rebuilt for long reads in {time.time() - t0:.0f}s")
        rs = ReadSimulator(rng, insertion_rate=0.005, deletion_rate=0.005)
        gene_windows = []
        for locus in GENES:
            cols = [i for i, n in enumerate(sim.column_names)
                    if f"_gene_{locus}_" in n]
            gene_windows.append((min(cols) - 600, max(cols) + 600))
        reads = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            for gi, (lo, hi) in enumerate(gene_windows):
                sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
                src = seq[sel[0]:sel[-1] + 1]
                slv = levels[sel[0]:sel[-1] + 1]
                made, i = 0, 0
                while made < 35.0 * len(src):
                    L = int(np.clip(rng.lognormal(np.log(2600), 0.25),
                                    1500, min(3800, len(src) - 1)))
                    rs.read_length = L
                    start = int(rng.integers(0, max(1, len(src) - L)))
                    r = rs._sequence_read(src, slv, start)
                    if r is None:
                        continue
                    reads.append((f"lr_h{h}g{gi}:::{i}",) + r[:2])
                    made += L
                    i += 1
        with open(cache_f + ".tmp", "wb") as fh:
            pickle.dump(reads, fh)
        os.replace(cache_f + ".tmp", cache_f)
        log(f"{len(reads)} long reads simulated")
    with open(cache_f, "rb") as fh:
        raw = pickle.load(fh)
    fq = [FastqRead(*r) for r in raw]
    log(f"{len(fq)} long reads, "
        f"{sum(len(r.seq) for r in fq) / 1e6:.1f} Mb")

    n_workers = min(os.cpu_count() or 1, 8)
    assert spawn_safe(), "stress requires spawn-safe __main__"
    engine = ParallelAligner(pkg_dir, n_workers, long_reads="ont2d")
    t0 = time.time()
    unal = engine.align_unpaired(fq)
    t_align = time.time() - t0
    engine.close()
    kept = [(r, a) for r, a in zip(fq, unal) if a is not None]
    log(f"align (long, unpaired): {t_align:.1f}s, "
        f"{len(kept)}/{len(fq)} aligned")
    assert len(kept) >= 0.9 * len(fq)

    pkg = GraphPackage(pkg_dir)
    out_dir = os.path.join(CACHE, "out_long")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    typer = HLATyper(pkg)
    t0 = time.time()
    res = typer.type_all([], [], [r for r, _ in kept],
                         [a for _, a in kept], 300.0, 25.0, out_dir,
                         long_reads_mode="ont2d")
    t_type = time.time() - t0
    by_locus = {r.locus: r for r in res}
    for locus in GENES:
        r = by_locus[locus]
        called = [set(r.allele1_id.split(";")), set(r.allele2_id.split(";"))]
        for h in TRUTH_HAPS:
            want = f"{locus}*{h + 1:02d}:01"
            assert any(want in c for c in called), (locus, want, called)
        assert r.n_clusters >= 2000, (locus, r.n_clusters)
        log(f"{locus}: C={r.n_clusters}, R={r.n_reads_used}, calls "
            f"{r.allele1_id.split(';')[0]}/{r.allele2_id.split(';')[0]} "
            f"exact (long mode)")
    log(f"SUMMARY(long): align {t_align:.1f}s, typing {t_type:.1f}s, "
        f"peak RSS {rss_gb():.2f} GB")
    print("STRESS_IMGT_LONG OK")


def main():
    if "--long" in sys.argv:
        if not os.path.exists(os.path.join(CACHE, "pkg",
                                           "serializedGRAPH.npz")):
            log("building IMGT-scale world (cold; cached)")
            build_cache()
        run_long_mode()
        return
    full_numpy = "--full-numpy" in sys.argv
    if "--fresh" in sys.argv and os.path.exists(CACHE):
        shutil.rmtree(CACHE)

    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.io.fastq import FastqRead
    from hla_la_tpu.models.parallel_host import ParallelAligner, spawn_safe
    from hla_la_tpu.models.typer import HLATyper

    if not os.path.exists(os.path.join(CACHE, "pairs.pkl")):
        log("building IMGT-scale world (cold; cached)")
        build_cache()
    fq_raw = pickle.load(open(os.path.join(CACHE, "pairs.pkl"), "rb"))
    fq = [(FastqRead(*a), FastqRead(*b)) for a, b in fq_raw]
    log(f"{len(fq)} read pairs, {len(GENES)} loci x {N_ALLELES} alleles")

    pkg_dir = os.path.join(CACHE, "pkg")
    n_workers = min(os.cpu_count() or 1, 8)
    assert spawn_safe(), "stress requires spawn-safe __main__"
    engine = ParallelAligner(pkg_dir, n_workers)
    # insert stats are the INNER mate distance in graph levels
    # (pair_distance_graph_levels semantics): fragment 300 - 2x100 read
    ins_mean, ins_sd = 100, 25
    engine.align_pairs(fq[:64], ins_mean, ins_sd)   # warmup
    t0 = time.time()
    aligned = engine.align_pairs(fq, ins_mean, ins_sd)
    t_align = time.time() - t0
    if not hasattr(aligned, "pack"):   # packed form has no None slots
        aligned = [ap for ap in aligned if ap is not None]
    log(f"align: {t_align:.1f}s = {2 * len(fq) / t_align:.0f} reads/s "
        f"({len(aligned)}/{len(fq)} pairs)")
    engine.close()
    aligned_ids = (set(aligned.read_ids)
                   if hasattr(aligned, "read_ids")
                   else {ap.read_id for ap in aligned})
    kept_fq = [p for p in fq if p[0].name in aligned_ids]

    pkg = GraphPackage(pkg_dir)
    out_dir = os.path.join(CACHE, "out")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    rss_before = rss_gb()
    t0 = time.time()
    typer = HLATyper(pkg)
    res = typer.type_all(kept_fq, aligned, [], [], float(ins_mean),
                         float(ins_sd), out_dir, n_workers=1)
    t_type = time.time() - t0
    log(f"typing (serial, backend auto): {t_type:.1f}s; "
        f"peak RSS {rss_gb():.2f} GB (was {rss_before:.2f} before typing)")

    # ---- checks -----------------------------------------------------
    by_locus = {r.locus: r for r in res}
    C_max = R_max = 0
    for locus in GENES:
        r = by_locus[locus]
        # identical-exon decoys legitimately merge into the truth cluster
        # (the IMGT G-group phenomenon) — the truth allele must be IN the
        # called cluster, and the two clusters must be the two haplotypes'
        called = [set(r.allele1_id.split(";")), set(r.allele2_id.split(";"))]
        for h in TRUTH_HAPS:
            want = f"{locus}*{h + 1:02d}:01"
            assert any(want in c for c in called), (locus, want, called)
        assert r.q1_allele1 > 0.9 and r.q1_allele2 > 0.9, \
            (locus, r.q1_allele1, r.q1_allele2)
        assert r.n_clusters >= 2000, (locus, r.n_clusters)
        # class-II loci type on exon 2 only (LOCI_2_EXONS, reference
        # semantics) — half the typed columns, half the usable reads
        from hla_la_tpu.utils.config import LOCI_2_EXONS
        floor = 5_000 * len(LOCI_2_EXONS.get(locus, ["e2", "e3"]))
        assert r.n_reads_used >= floor, (locus, r.n_reads_used, floor)
        C_max = max(C_max, r.n_clusters)
        R_max = max(R_max, r.n_reads_used)
        n_pairs = r.n_clusters * (r.n_clusters + 1) // 2
        with open(os.path.join(out_dir, f"R1_PP_{locus}_pairs.txt")) as fh:
            n_lines = sum(1 for _ in fh)
        assert n_lines == n_pairs + 1, (locus, n_lines, n_pairs)
        log(f"{locus}: C={r.n_clusters}, R={r.n_reads_used}, "
            f"calls {r.allele1_id.split(';')[0]}/"
            f"{r.allele2_id.split(';')[0]} exact, {n_pairs} pairs dumped")
    peak = rss_gb()
    assert peak < 12.0, f"peak RSS {peak:.2f} GB — tiling regressed"

    # ---- per-locus fan-out at IMGT scale: byte-identical --------------
    # (gate lowered explicitly: the production default needs >=4 loci —
    # at 2 ultra-deep loci serial wins since workers run the native pair
    # kernel single-threaded, measured r3: 109.6s serial vs 111.5s fan-out)
    out_dir2 = os.path.join(CACHE, "out_fanout")
    if os.path.exists(out_dir2):
        shutil.rmtree(out_dir2)
    from dataclasses import replace
    typer2 = HLATyper(pkg)
    n_fan = min(len(GENES), os.cpu_count() or 2)
    if len(GENES) < typer2.cfg.min_loci_for_typing_workers:
        # 2-locus world: engage the path via explicit override (the
        # production gate needs >=4 loci, see config.py)
        typer2.cfg = replace(typer2.cfg,
                             min_loci_for_typing_workers=len(GENES))
    t0 = time.time()
    typer2.type_all(kept_fq, aligned, [], [], float(ins_mean),
                    float(ins_sd), out_dir2, n_workers=n_fan)
    t_fan = time.time() - t0
    import filecmp
    names = sorted(os.listdir(out_dir))
    assert names == sorted(os.listdir(out_dir2))
    match, mismatch, errors = filecmp.cmpfiles(out_dir, out_dir2, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    log(f"fan-out ({n_fan} workers): {t_fan:.1f}s vs serial {t_type:.1f}s — "
        f"{len(match)} output files byte-identical")

    if "--sharded" in sys.argv:
        time_sharded_reduction(C_max, R_max)

    if "--skip-kernels" in sys.argv:
        log(f"SUMMARY: align {t_align:.1f}s, typing {t_type:.1f}s serial / "
            f"{t_fan:.1f}s fan-out (both loci), C={C_max}, R={R_max}, "
            f"peak RSS {peak:.2f} GB (kernel timing skipped)")
    else:
        t_jax, t_np = time_pair_reduction(C_max, R_max, full_numpy)
        log(f"SUMMARY: align {t_align:.1f}s, typing {t_type:.1f}s "
            f"(both loci), C={C_max}, R={R_max}, peak RSS {peak:.2f} GB, "
            f"C^2 kernel jax {t_jax:.1f}s / numpy ~{t_np:.0f}s")
    print("STRESS_IMGT OK")


if __name__ == "__main__":
    main()
