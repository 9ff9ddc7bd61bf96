"""Banded NW tests: exact recovery, indels, numpy/JAX agreement
(build plan step 3/4; the reference's testChainExtension property —
an extended chain must reproduce the read exactly, HLA-LA.cpp:1733-1861)."""

import numpy as np
import pytest

from hla_la_tpu.ops.banded_nw import (NWScoring, banded_nw_backtrace,
                                      banded_nw_forward, make_jax_banded_nw,
                                      CIGAR_M, CIGAR_I, CIGAR_D)

_ENC = {b: i for i, b in enumerate("ACGT")}


def enc(s, width=None, pad=4):
    if width is not None:
        s = s[:width]
    a = np.full(width or len(s), pad, dtype=np.uint8)
    a[:len(s)] = [_ENC.get(c, 4) for c in s]
    return a


def run_single(read, ref_window, W=8):
    L = len(read)
    reads = enc(read)[None, :]
    refs = enc(ref_window, width=L + W)[None, :]
    lens = np.array([L])
    s, k, st, ptr = banded_nw_forward(reads, lens, refs)
    ops = banded_nw_backtrace(ptr[0], L, int(k[0]), int(st[0]))
    return float(s[0]), ops


REF = "TTGACCAGTCAGAATCGGCAGTCCTAACGTGAGCATTGCCA"


def test_exact_match():
    ref = REF
    read = ref[6:16]
    # window starts W//2 before the true start
    s, ops = run_single(read, ref[6 - 4:], W=8)
    assert s == 2.0 * len(read)
    assert all(op == CIGAR_M for op, _, _ in ops)
    assert len(ops) == len(read)
    # ref positions must be consecutive starting at 4 (the W//2 offset)
    assert [rp for _, _, rp in ops] == list(range(4, 4 + len(read)))


def test_mismatch_scoring():
    ref = "AAAAAAAAAACCCCCCCCCC"
    read = "AAAAAGAAAA"
    s, ops = run_single(read, ref[:18], W=8)
    # expected: 9 matches + 1 mismatch, read aligns at offset 4 in window
    # but leading ref skip is free so it may slide; score must be 9*2 - 5
    assert s == pytest.approx(9 * 2 - 5)


def test_deletion():
    ref = REF
    read = (ref[6:13] + ref[16:21])  # 3-base deletion
    window = ref[6 - 5:]
    s, ops = run_single(read, window, W=10)
    kinds = [op for op, _, _ in ops]
    assert kinds.count(CIGAR_D) == 3
    assert s == pytest.approx(2 * len(read) + (-6) + 2 * (-2))


def test_insertion():
    ref = REF
    read = ref[6:12] + "TT" + ref[12:18]
    s, ops = run_single(read, ref[6 - 4:], W=8)
    kinds = [op for op, _, _ in ops]
    assert kinds.count(CIGAR_I) == 2
    assert s == pytest.approx(2 * 12 + (-6) + (-2))


def test_read_overhangs_ref_end():
    ref = REF[:10]
    read = ref[6:] + "GGGG"   # 4 bases hang past the reference end
    s, ops = run_single(read, ref[6 - 4:], W=8)
    kinds = [op for op, _, _ in ops]
    assert kinds.count(CIGAR_M) == 4
    assert kinds.count(CIGAR_I) == 4


def test_batch_variable_lengths():
    ref = REF
    reads_s = [ref[2:12], ref[4:10]]  # offsets 2 and 4 within the window
    L = 10
    W = 8
    reads = np.stack([enc(r, width=L) for r in reads_s])
    lens = np.array([10, 6])
    refs = np.stack([enc(ref[0:0 + L + W], width=L + W),
                     enc(ref[0:0 + L + W], width=L + W)])
    s, k, st, ptr = banded_nw_forward(reads, lens, refs)
    assert s[0] == 20.0
    assert s[1] == 12.0


def test_jax_matches_numpy(rng):
    L, W, B = 24, 12, 16
    bases = "ACGT"
    ref_full = "".join(rng.choice(list(bases)) for _ in range(200))
    reads = np.zeros((B, L), dtype=np.uint8)
    refs = np.zeros((B, L + W), dtype=np.uint8)
    lens = np.full(B, L)
    for b in range(B):
        start = int(rng.integers(0, 150))
        read = list(ref_full[start:start + L])
        # random mutations
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, L))
            read[p] = bases[int(rng.integers(4))]
        reads[b] = enc("".join(read))
        refs[b] = enc(ref_full[max(start - W // 2, 0):], width=L + W)
    s_np, k_np, st_np, _ = banded_nw_forward(reads, lens, refs)
    fwd = make_jax_banded_nw(L, W)
    s_j, k_j, st_j, _ = (np.asarray(x) for x in fwd(reads, lens, refs))
    np.testing.assert_allclose(s_np, s_j, rtol=1e-6)
    np.testing.assert_array_equal(k_np, k_j)


@pytest.mark.parametrize("W", [16, 32, 48, 64, 128, 24])
def test_native_matches_numpy(rng, W):
    """Exact parity for every native kernel bucket: the AVX-512 widths
    (16/32/48/64/128) and a non-multiple-of-16 width (generic scalar
    path).  Includes N/pad codes (masked-lane rows) and short lens."""
    from hla_la_tpu import native
    if not native.available():
        pytest.skip("native lib not built")
    from hla_la_tpu.ops.banded_nw import banded_nw_forward
    B, L = 64, 40
    for hi in (5, 4):   # with N/pad codes (masked rows) and pure ACGT
        reads = rng.integers(0, hi, (B, L)).astype(np.uint8)
        refs = rng.integers(0, hi, (B, L + W)).astype(np.uint8)
        lens = rng.integers(5, L + 1, B).astype(np.int64)
        a = banded_nw_forward(reads, lens, refs, use_native=True)
        b = banded_nw_forward(reads, lens, refs, use_native=False)
        ok = b[0] > -1e29   # unalignable rows may tie-break differently
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
        np.testing.assert_array_equal(a[1][ok], b[1][ok])
        np.testing.assert_array_equal(a[2][ok], b[2][ok])
        np.testing.assert_array_equal(a[3], b[3])


def test_jax_scan_nw_n_bases_parity(rng):
    """XLA-scan variant: segmented cummax must match the sequential
    recurrence on N-containing sequences."""
    import numpy as np

    from hla_la_tpu.ops.banded_nw import banded_nw_forward, \
        make_jax_banded_nw

    Bk, Lk, Wk = 64, 48, 16
    reads = rng.integers(0, 5, (Bk, Lk)).astype(np.uint8)
    refs = rng.integers(0, 5, (Bk, Lk + Wk)).astype(np.uint8)
    lens = rng.integers(16, Lk + 1, Bk).astype(np.int64)
    fwd = make_jax_banded_nw(Lk, Wk)
    out_j = tuple(np.asarray(x) for x in fwd(reads, lens, refs))
    out_p = banded_nw_forward(reads, lens, refs, use_native=False)
    assert np.allclose(out_j[0], out_p[0], atol=1e-4)
    live = np.asarray(out_p[0]) > -1e29     # see test_pallas_nw note
    for i in (1, 2, 3):
        assert (out_j[i].astype(np.int64)
                == np.asarray(out_p[i]).astype(np.int64))[live].all()
