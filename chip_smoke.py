#!/usr/bin/env python
"""Smoke test of the device path on an NVIDIA GPU: python chip_smoke.py

Drives `--action HLA --backend jax` through the CLI entry point on a
real-scale simulated sample and checks every device kernel of that path
against the repository's references.  Phases:

  (a) device line: platform, device_kind, count, card name and power limit;
  (b) banded-NW forward at real widths vs the host reference (exact);
  (c) typing kernels: cluster LL and the C^2 pair reduction vs numpy f64;
  (d) end to end through hla_la_tpu.cli.main on a 3M-level package with
      ~29.6k read pairs (written once as a BAM under .smoke_world/): cold
      and warm wall time and reads/s, calls checked against the planted
      truth and against a --backend auto host run.

`--multi` runs only the multi-device path (`--backend sharded`, the
sharded NW and the sharded C^2 reduction) and what it is compared with.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or without the hla_la_tpu package next to this file, the
script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD_DIR = os.path.join(HERE, ".smoke_world")
WORLD_LEVELS = 3_000_000
WORLD_SEED = 31337
TRUTH = {"A": ["A*02:01", "A*03:01"], "B": ["B*02:01", "B*03:01"]}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------- world
def build_world(world_dir: str = WORLD_DIR, n_levels: int = WORLD_LEVELS,
                seed: int = WORLD_SEED) -> dict:
    """The real-scale sample: a 3M-level package with 8 haplotypes and
    genes A/B, 101 bp pairs at 1x per haplotype from haplotypes 1 and 2,
    written as a BAM on one contig with a matching knownReferences spec.
    Built once; later runs reuse it."""
    from hla_la_tpu.io.bam import (BamRecord, BamWriter, FLAG_PAIRED,
                                   FLAG_READ1, FLAG_READ2, FLAG_REVERSE)
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp

    pkg_dir = os.path.join(world_dir, "pkg")
    bam_path = os.path.join(world_dir, "sample.bam")
    done = os.path.join(world_dir, "done.json")
    key = {"n_levels": n_levels, "seed": seed}
    if os.path.exists(done):
        with open(done) as fh:
            meta = json.load(fh)
        if meta.get("key") == key:
            return dict(meta, pkg=pkg_dir, bam=bam_path, built_s=0.0)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(
        rng, backbone_length=n_levels, n_haplotypes=8, snp_rate=0.01,
        genes={"A": (0.30, 0.31), "B": (0.60, 0.61)})
    sim.write_package(pkg_dir)
    contig_len = 2 * n_levels
    with open(os.path.join(pkg_dir, "knownReferences", "smoke.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    rs = ReadSimulator(rng, read_length=101, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 1.0,
                                               name_prefix=f"h{h}")
    w = BamWriter(bam_path, [("chr6", contig_len)])
    for p in pairs:
        for mate_flag, r in ((FLAG_READ1, p.r1), (FLAG_READ2, p.r2)):
            seq, qual = r.seq, r.qual
            flag = FLAG_PAIRED | mate_flag
            if r.reverse:
                seq, qual = revcomp(seq), qual[::-1]
                flag |= FLAG_REVERSE
            w.write(BamRecord(name=r.name, flag=flag, ref_id=0,
                              pos=max(r.start_pos, 0), mapq=60,
                              cigar=[(len(seq), 0)], seq=seq, qual=qual))
    w.close()
    meta = {"key": key, "n_pairs": len(pairs)}
    with open(done, "w") as fh:
        json.dump(meta, fh)
    return dict(meta, pkg=pkg_dir, bam=bam_path, built_s=time.time() - t0)


def read_calls(out_dir: str) -> dict:
    """{locus: ([allele, allele], [Q1, Q1])} from R1_bestguess.txt."""
    calls: dict = {}
    with open(os.path.join(out_dir, "hla", "R1_bestguess.txt")) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        ia, iq = head.index("Allele"), head.index("Q1")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            al, q = calls.setdefault(f[0], ([], []))
            al.append(f[ia])
            q.append(float(f[iq]))
    return calls


def run_cli(world: dict, out_dir: str, backend: str) -> tuple[float, dict]:
    from hla_la_tpu.cli import main
    t0 = time.time()
    rc = main(["--action", "HLA", "--BAM", world["bam"], "--graph",
               world["pkg"], "--sampleID", "S1", "--workingDir", out_dir,
               "--outputDirectory", out_dir, "--backend", backend])
    wall = time.time() - t0
    if rc != 0:
        fail(f"cli.main --backend {backend} returned {rc}")
    return wall, read_calls(out_dir)


def same_calls(got: dict, want: dict, what: str) -> None:
    if {k: v[0] for k, v in got.items()} != \
            {k: v[0] for k, v in want.items()}:
        fail(f"{what}: calls differ: {got} vs {want}")
    dq = max(abs(a - b) for k in got for a, b in zip(got[k][1], want[k][1]))
    if dq > 1e-3:
        fail(f"{what}: Q1 differs by {dq}")
    say(f"  {what}: calls equal, max |dQ1| = {dq!r}")


# ---------------------------------------------------------------- phases
def nw_world(rng, B: int, L: int, W: int):
    """Reads copied from their windows with errors, N bases in reads and
    references, and suffix reference pads (haplotype ends)."""
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    copy = rng.random(B) < 0.8
    reads[copy] = refs[copy, W // 2:W // 2 + L]
    err = rng.random((B, L)) < 0.02
    reads[err] = rng.integers(0, 4, int(err.sum()))
    reads[rng.random((B, L)) < 0.002] = 4
    refs[rng.random((B, L + W)) < 0.001] = 4
    for b in range(0, B, 5):
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    lens[::7] = min(101, L)
    return reads, lens, refs


def device_time(fn, args, reps: int = 7) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_nw(shapes=((128, 32, 4096), (256, 32, 4096))) -> None:
    import jax
    from hla_la_tpu import device
    from hla_la_tpu.ops.banded_nw import banded_nw_forward
    say("(b) banded-NW forward vs the host reference (exact on rows "
        "with score > -1e29)")
    rng = np.random.default_rng(7)
    for L, W, B in shapes:
        reads, lens, refs = nw_world(rng, B, L, W)
        want = banded_nw_forward(reads, lens, refs)
        fwd = device.nw_forward(L, W)
        args = tuple(jax.device_put(x) for x in (reads, lens, refs))
        got = [np.asarray(x) for x in fwd(*args)]
        ok = want[0] > -1e29
        for name, g, w in zip(("score", "end_k", "end_state", "pointers"),
                              got, want):
            if not np.array_equal(g[ok], w[ok]):
                fail(f"NW {name} differs at L={L} W={W} B={B}")
        t = device_time(fwd, args)
        say(f"  L={L} W={W} B={B}: equal on {int(ok.sum())}/{B} alignable "
            f"rows; device {t * 1e3!r} ms = "
            f"{B * L * W / t / 1e9!r} Gcells/s")


def phase_typing(J: int = 540, C: int = 2200, R_ll: int = 4096,
                 R_pair: int = 16384, n_rows: int = 16) -> None:
    from hla_la_tpu.ops.pair_ll import (LOG_HALF, cluster_read_ll,
                                        pair_ll_reduction)
    say("(c) typing kernels vs numpy f64")
    rng = np.random.default_rng(11)
    ch = rng.integers(0, 6, (C, J))
    onehot = np.zeros((C, J, 6), np.float32)
    onehot[np.arange(C)[:, None], np.arange(J)[None, :], ch] = 1.0
    contrib = -np.abs(rng.normal(1.0, 0.5, (R_ll, J, 6)))
    contrib = contrib.astype(np.float32)
    mism = (rng.random((R_ll, J, 6)) < 0.1).astype(np.float32)
    t0 = time.perf_counter()
    ll, mm = cluster_read_ll(onehot, contrib, mism, backend="jax")
    t_ll = time.perf_counter() - t0
    A = onehot.reshape(C, J * 6).astype(np.float64)
    ref_ll = A @ contrib.reshape(R_ll, J * 6).T.astype(np.float64)
    ref_mm = A @ mism.reshape(R_ll, J * 6).T.astype(np.float64)
    rtol = 1e-5
    for name, g, w in (("LL", ll, ref_ll), ("mismatches", mm, ref_mm)):
        err = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
        say(f"  cluster_read_ll {name} J={J} C={C} R={R_ll}: max rel err "
            f"{err!r} (rtol {rtol}); {t_ll!r} s incl. transfers")
        if not np.allclose(g, w, rtol=rtol, atol=0.0):
            fail(f"cluster_read_ll {name} outside rtol {rtol}")

    Lm = rng.normal(-40.0, 8.0, (C, R_pair))
    t0 = time.perf_counter()
    got = pair_ll_reduction(Lm, backend="jax")
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = pair_ll_reduction(Lm, backend="jax")
    t_warm = time.perf_counter() - t0
    rows = np.unique(np.r_[0, C - 1, rng.integers(0, C, n_rows - 2)])
    want = np.zeros((len(rows), C))
    for lo in range(0, R_pair, 1024):
        a = Lm[rows, None, lo:lo + 1024]
        b = Lm[None, :, lo:lo + 1024]
        hi = np.maximum(a, b)
        want += (LOG_HALF + hi + np.log1p(np.exp(np.minimum(a, b) - hi))
                 ).sum(axis=2)
    rtol, atol = 1e-6, 1e-2
    err = np.abs(got[rows] - want)
    say(f"  pair_ll_reduction C={C} R={R_pair} ({len(rows)} rows checked): "
        f"max abs err {float(err.max())!r}, max rel err "
        f"{float((err / np.abs(want)).max())!r} (rtol {rtol}, atol {atol}); "
        f"{t_cold!r} s cold, {t_warm!r} s warm incl. transfers")
    if not np.allclose(got[rows], want, rtol=rtol, atol=atol):
        fail("pair_ll_reduction outside tolerance")


def phase_e2e(world: dict) -> None:
    say("(d) end to end: cli.main --action HLA --backend jax")
    n_reads = 2 * world["n_pairs"]
    base = os.path.join(WORLD_DIR, "runs")
    runs = {}
    for label in ("cold", "warm"):
        wall, runs[label] = run_cli(
            world, os.path.join(base, f"jax_{label}"), "jax")
        say(f"  --backend jax {label}: {wall!r} s wall, "
            f"{n_reads / wall!r} reads/s ({n_reads} reads)")
    for label, calls in runs.items():
        if {k: sorted(calls.get(k, ([], []))[0]) for k in TRUTH} != TRUTH:
            fail(f"{label} run: calls {calls} differ from the planted "
                 f"truth {TRUTH}")
    say(f"  cold and warm calls equal the planted truth {TRUTH}")
    wall, host = run_cli(world, os.path.join(base, "host"), "auto")
    say(f"  --backend auto (host): {wall!r} s wall, "
        f"{n_reads / wall!r} reads/s")
    for label, calls in runs.items():
        same_calls(calls, host, f"jax {label} vs host")


def phase_multi_kernels(C: int = 2200, R: int = 16384) -> None:
    import jax
    from hla_la_tpu import device
    from hla_la_tpu.ops.pair_ll import pair_ll_reduction
    from hla_la_tpu.parallel.mesh import (ShardedNW, make_mesh,
                                          pair_ll_reduction_sharded)
    n = len(jax.devices())
    if n < 2:
        fail(f"--multi needs several devices, found {n}")
    say(f"(multi) sharded NW over {n} devices vs one device")
    L, W, B = 128, 32, 4096
    reads, lens, refs = nw_world(np.random.default_rng(3), B, L, W)
    sh = ShardedNW(make_mesh(n), L, W)
    out = sh.step(reads, lens, refs)
    used = {d for x in out for d in x.sharding.device_set}
    if len(used) != n:
        fail(f"sharded NW placed its shards on {len(used)} of {n} devices")
    one = device.nw_forward(L, W)(reads, lens, refs)
    for name, a, b in zip(("score", "end_k", "end_state", "pointers"),
                          out, one):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            fail(f"sharded NW {name} differs from one device")
    say(f"  shards on all {n} devices; outputs equal to one device")

    Lm = np.random.default_rng(5).normal(-40.0, 8.0, (C, R))
    t0 = time.perf_counter()
    got = pair_ll_reduction_sharded(Lm)
    t_sh = time.perf_counter() - t0
    want = pair_ll_reduction(Lm, backend="jax")
    rtol, atol = 1e-6, 1e-2
    err = float(np.abs(got - want).max())
    say(f"  pair_ll_reduction_sharded C={C} R={R}: max abs err vs one "
        f"device {err!r} (rtol {rtol}, atol {atol}); {t_sh!r} s cold")
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        fail("sharded pair reduction differs from one device")


def phase_multi_e2e(world: dict) -> None:
    say("(multi) end to end: --backend sharded vs --backend jax")
    base = os.path.join(WORLD_DIR, "runs")
    n_reads = 2 * world["n_pairs"]
    res = {}
    for backend in ("jax", "sharded"):
        wall, res[backend] = run_cli(
            world, os.path.join(base, f"multi_{backend}"), backend)
        say(f"  --backend {backend}: {wall!r} s wall, "
            f"{n_reads / wall!r} reads/s")
    same_calls(res["sharded"], res["jax"], "sharded vs one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device (sharded) path")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "hla_la_tpu")):
        fail("the hla_la_tpu package is not next to chip_smoke.py")
    sys.path.insert(0, HERE)
    from hla_la_tpu import device
    device.setup_compile_cache()
    info = device.describe()
    if info["platform"] != "gpu":
        fail(f"no GPU: JAX platform is {info['platform']!r}")
    say("(a) " + device.device_line(info))
    say(info["nvidia_smi"])
    t0 = time.time()
    if args.multi:
        phase_multi_kernels()
    else:
        phase_nw()
        phase_typing()
    world = build_world()
    say(f"world: {WORLD_LEVELS} levels, {world['n_pairs']} read pairs; "
        f"build {world['built_s']!r} s (0 = reused)")
    if args.multi:
        phase_multi_e2e(world)
    else:
        phase_e2e(world)
    say(f"total {time.time() - t0!r} s")
    say(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0



if __name__ == "__main__":
    sys.exit(main())
