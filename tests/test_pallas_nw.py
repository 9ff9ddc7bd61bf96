"""The device banded-NW forward (device.nw_forward, the XLA scan of
ops/banded_nw) vs the numpy reference: identical scores, end cells and
pointer bits on every row with an alignment.  The gpu-marked test at the
end runs the same comparison compiled on the card."""

import numpy as np
import pytest

from hla_la_tpu.device import nw_forward
from hla_la_tpu.ops.banded_nw import banded_nw_backtrace, banded_nw_forward


def _world(rng, B=40, L=24, W=16):
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    for b in range(0, B, 3):   # realistic suffix-only ref pads
        cut = int(rng.integers(L // 2, L + W))
        refs[b, cut:] = 4
    lens = rng.integers(4, L + 1, B).astype(np.int64)
    return reads, refs, lens


def _assert_same(got, want):
    # fully unalignable rows (score ~ NEG) may tie-break their end cell
    # differently; the aligner discards them (score <= -1e29 -> None)
    ok = want[0] > -1e29
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g)[ok], w[ok])


@pytest.mark.parametrize("B,L,W", [(40, 32, 16), (64, 16, 8)])
def test_pallas_nw_matches_numpy(rng, B, L, W):
    reads, refs, lens = _world(rng, B, L, W)
    lens[0] = 0                 # empty read: harvested at row 0
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    got = tuple(np.asarray(x) for x in nw_forward(L, W)(reads, lens, refs))
    _assert_same(got, want)
    # backtraces agree wherever an alignment exists
    for b in np.nonzero(want[0] > -1e29)[0]:
        ops_a = banded_nw_backtrace(got[3][b], int(lens[b]), int(got[1][b]),
                                    int(got[2][b]))
        ops_b = banded_nw_backtrace(want[3][b], int(lens[b]),
                                    int(want[1][b]), int(want[2][b]))
        assert ops_a == ops_b, b


@pytest.mark.parametrize("B", [13, 1])
def test_pallas_nw_uneven_batch(rng, B):
    # a batch of no particular size keeps the [B, L+1, W] uint8 contract
    L, W = 16, 8
    reads, refs, lens = _world(rng, B, L, W)
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    got = tuple(np.asarray(x) for x in nw_forward(L, W)(reads, lens, refs))
    assert got[3].shape == want[3].shape == (B, L + 1, W)
    assert got[3].dtype == np.uint8
    _assert_same(got, want)


def test_pallas_nw_n_bases_parity(rng):
    """Reads/refs containing N (code 4) mid-sequence: a deletion run must
    not cross a masked reference position (the sequential recurrence of
    the reference)."""
    Bk, Lk, Wk = 48, 64, 16
    reads = rng.integers(0, 5, (Bk, Lk)).astype(np.uint8)
    refs = rng.integers(0, 5, (Bk, Lk + Wk)).astype(np.uint8)
    lens = rng.integers(20, Lk + 1, Bk).astype(np.int64)
    got = tuple(np.asarray(x)
                for x in nw_forward(Lk, Wk)(reads, lens, refs))
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    _assert_same(got, want)


@pytest.mark.parametrize("L,W", [(128, 32), (256, 32)])
def test_pallas_nw_lowers_for_cuda(L, W):
    """The device NW lowers for the GPU at the aligner's real shapes as
    plain XLA (the GPU compiler itself runs only on the card)."""
    import jax
    B = 4096
    lowered = jax.jit(nw_forward(L, W)).trace(
        np.zeros((B, L), np.uint8), np.zeros(B, np.int32),
        np.zeros((B, L + W), np.uint8)).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "stablehlo.while" in text
    assert "custom_call" not in text


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("L,W,B", [(128, 32, 1000), (256, 32, 4096)])
def test_pallas_nw_compiled_on_gpu(rng, gpu, L, W, B):
    reads, refs, lens = _world(rng, B, L, W)
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    got = nw_forward(L, W)(reads, lens, refs)
    assert next(iter(got[0].devices())) == gpu
    _assert_same(got, want)
