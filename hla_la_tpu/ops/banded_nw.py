"""Batched banded glocal affine-gap Needleman-Wunsch (read vs haplotype window).

Batched redesign of the reference's extension DP: the reference runs a
dynamic, sparsely-banded 3-state NW *over the graph* per read
(fullNeedleman_diagonal_extension_gapJumper, extensionAligner.cpp:335-1557).
Here the whole read is instead aligned to the *linearized haplotype window*
its seed chain anchors to — a fixed-shape [B, L, W] three-state banded DP that
batches across reads — and the result is projected into graph coordinates via
the level-translation arrays (models/projection.py).  Graph '_' columns come
back in projection with zero cost (S_graphGap = 0, alignerBase.cpp:22), and
path recombination across haplotypes is recovered by scoring every candidate
haplotype (the seeder's bwa `-a` analogue).  A faithful graph-space DP is kept
in ops/graph_dp.py as the fallback/verification path.

Scoring mirrors alignerBase.cpp:19-25: match +2, mismatch -5, gap open -4 +
extend -2 charged together on the first gap character, -2 per extension.

Cell space: (i, k) with i = read prefix length 0..L, k = band offset 0..W-1,
ref prefix j = i + k.  The window must be built as ref[anchor - W//2 ...] so
the expected diagonal sits at k = W//2.  Row 0 is free (glocal: leading ref
skipped); trailing ref is skipped by taking the max over k at row L.

States: D (match/mismatch), IY (insertion in read: consumes read, ref gap),
IX (deletion: consumes ref, read gap).  IX has a within-row scan over k.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = np.float32(-1e30)

# pointer bit layout per cell (uint8):
#   bits 0-1: D came from state {0=D,1=IY,2=IX} at (i-1, k)
#   bit 2:    IY came from IY (else D) at (i-1, k+1)
#   bit 3:    IX came from IX (else D) at (i,   k-1)


@dataclass(frozen=True)
class NWScoring:
    match: float = 2.0
    mismatch: float = -5.0
    gap_open: float = -6.0     # S_openGap + S_extendGap for the first gap char
    gap_extend: float = -2.0


def _substitution(read_col: np.ndarray, ref_col: np.ndarray,
                  sc: NWScoring) -> np.ndarray:
    """[B, W] substitution scores; padding code 4+ never matches and ref pad
    (code >= 4) is unalignable."""
    ok = (read_col[:, None] == ref_col) & (read_col[:, None] < 4)
    s = np.where(ok, np.float32(sc.match), np.float32(sc.mismatch))
    return np.where(ref_col >= 4, NEG, s).astype(np.float32)


def banded_nw_forward(reads: np.ndarray, read_lens: np.ndarray,
                      refs: np.ndarray, sc: NWScoring = NWScoring(),
                      use_native: bool = True, scratch: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Forward DP.

    reads: [B, L] uint8 base codes 0-3 (>=4 pad)
    read_lens: [B] actual lengths
    refs: [B, L + W] uint8 window codes (>=4 pad); W inferred as refs.shape[1]-L
    Returns (final_scores [B], final_k [B], final_state [B],
             pointers [B, L+1, W] uint8).
    Dispatches to the C++ kernel (native/hla_native.cpp) when built.
    scratch: optional reuse pool for the native outputs (the ~150 MB
    pointer tensor dominates wrapper time when freshly allocated) —
    callers passing it must consume the results before the next call.
    """
    if use_native:
        from .. import native
        out = native.nw_forward(reads, read_lens, refs, sc.match,
                                sc.mismatch, sc.gap_open, sc.gap_extend,
                                scratch=scratch) \
            if native.available() else None
        if out is not None:
            return out
    B, L = reads.shape
    W = refs.shape[1] - L
    assert W >= 2
    open_, ext = np.float32(sc.gap_open), np.float32(sc.gap_extend)

    D = np.zeros((B, W), dtype=np.float32)
    IY = np.full((B, W), NEG, dtype=np.float32)
    IX = np.full((B, W), NEG, dtype=np.float32)
    pointers = np.zeros((B, L + 1, W), dtype=np.uint8)

    best_score = np.full(B, NEG, dtype=np.float32)
    best_k = np.zeros(B, dtype=np.int32)
    best_state = np.zeros(B, dtype=np.int32)

    def harvest(i, D, IY, IX):
        nonlocal best_score, best_k, best_state
        at_end = read_lens == i
        if not at_end.any():
            return
        stacked = np.stack([D, IY, IX])          # [3, B, W]
        flat = stacked.transpose(1, 0, 2).reshape(B, 3 * W)
        arg = np.argmax(flat, axis=1)
        sc_ = flat[np.arange(B), arg]
        best_score = np.where(at_end, sc_, best_score)
        best_state = np.where(at_end, arg // W, best_state)
        best_k = np.where(at_end, arg % W, best_k)

    harvest(0, D, IY, IX)
    for i in range(1, L + 1):
        # substitution column: read char y[i-1] vs ref chars x[i-1+k], k=0..W-1
        read_col = reads[:, i - 1]
        ref_col = np.stack([refs[:, i - 1 + k] for k in range(W)], axis=1)
        sub = _substitution(read_col, ref_col, sc)

        prev_best = np.maximum(np.maximum(D, IY), IX)
        m_src = np.where(D >= np.maximum(IY, IX), 0,
                         np.where(IY >= IX, 1, 2)).astype(np.uint8)
        nD = prev_best + sub                                   # [B, W]

        # IY: from (i-1, k+1)
        D_sh = np.concatenate([D[:, 1:], np.full((B, 1), NEG, np.float32)], axis=1)
        IY_sh = np.concatenate([IY[:, 1:], np.full((B, 1), NEG, np.float32)], axis=1)
        open_cand = D_sh + open_
        ext_cand = IY_sh + ext
        nIY = np.maximum(open_cand, ext_cand)
        iy_src = (ext_cand > open_cand).astype(np.uint8)

        # IX: within-row scan over k ascending; consuming ref pad is invalid
        nIX = np.full((B, W), NEG, dtype=np.float32)
        ix_src = np.zeros((B, W), dtype=np.uint8)
        ref_ok = ref_col < 4
        for k in range(1, W):
            oc = nD[:, k - 1] + open_
            ec = nIX[:, k - 1] + ext
            v = np.maximum(oc, ec)
            nIX[:, k] = np.where(ref_ok[:, k], v, NEG)
            ix_src[:, k] = (ec > oc).astype(np.uint8)

        pointers[:, i] = (m_src | (iy_src << 2) | (ix_src << 3))
        D, IY, IX = nD, nIY, nIX
        harvest(i, D, IY, IX)

    return best_score, best_k, best_state, pointers


CIGAR_M, CIGAR_I, CIGAR_D = 0, 1, 2


def banded_nw_backtrace(pointers: np.ndarray, read_len: int, end_k: int,
                        end_state: int) -> list[tuple[int, int, int]]:
    """Trace one read.  Returns ops list [(op, read_pos, ref_pos)] in forward
    order; read_pos/ref_pos are the 0-based positions consumed (op M consumes
    both, I consumes read only — ref_pos = next ref pos, D consumes ref only).
    Ref positions are window-relative (j = i + k)."""
    ops: list[tuple[int, int, int]] = []
    i, k, state = read_len, int(end_k), int(end_state)
    while i > 0 or state == 2:
        ptr = pointers[i, k]
        j = i + k
        if state == 0:
            if i == 0:
                break
            ops.append((CIGAR_M, i - 1, j - 1))
            state = int(ptr & 3)
            i -= 1
        elif state == 1:
            ops.append((CIGAR_I, i - 1, j))
            state = 1 if (ptr >> 2) & 1 else 0
            i -= 1
            k += 1
        else:
            ops.append((CIGAR_D, i, j - 1))
            state = 2 if (ptr >> 3) & 1 else 0
            k -= 1
        if k < 0 or k >= pointers.shape[1]:
            break
    ops.reverse()
    return ops


# --------------------------------------------------------------------- JAX
def make_jax_banded_nw(L: int, W: int, sc: NWScoring = NWScoring()):
    """jit-compiled forward DP over [B, L] reads / [B, L+W] windows using
    lax.scan over rows.  Returns (scores, end_k, end_state, pointers)."""
    import jax
    import jax.numpy as jnp

    open_, ext = jnp.float32(sc.gap_open), jnp.float32(sc.gap_extend)
    neg = jnp.float32(-1e30)

    @jax.jit
    def forward(reads, read_lens, refs):
        B = reads.shape[0]
        D0 = jnp.zeros((B, W), jnp.float32)
        IY0 = jnp.full((B, W), neg)
        IX0 = jnp.full((B, W), neg)
        best0 = (jnp.full((B,), neg), jnp.zeros((B,), jnp.int32),
                 jnp.zeros((B,), jnp.int32))

        # precompute banded ref view: ref_band[i, b, k] = refs[b, i + k]
        idx = (jnp.arange(L)[:, None] + jnp.arange(W)[None, :])  # [L, W]
        ref_band = refs[:, idx].transpose(1, 0, 2)               # [L, B, W]
        read_cols = reads.T                                      # [L, B]

        def harvest(i, D, IY, IX, best):
            bs, bk, bst = best
            at_end = read_lens == i
            stacked = jnp.stack([D, IY, IX])                     # [3, B, W]
            flat = stacked.transpose(1, 0, 2).reshape(B, 3 * W)
            arg = jnp.argmax(flat, axis=1)
            val = jnp.take_along_axis(flat, arg[:, None], axis=1)[:, 0]
            return (jnp.where(at_end, val, bs),
                    jnp.where(at_end, (arg % W).astype(jnp.int32), bk),
                    jnp.where(at_end, (arg // W).astype(jnp.int32), bst))

        def row(carry, xs):
            D, IY, IX, best = carry
            i, read_col, ref_col = xs
            ok = (read_col[:, None] == ref_col) & (read_col[:, None] < 4)
            sub = jnp.where(ref_col >= 4, neg,
                            jnp.where(ok, jnp.float32(sc.match),
                                      jnp.float32(sc.mismatch)))
            prev_best = jnp.maximum(jnp.maximum(D, IY), IX)
            m_src = jnp.where(D >= jnp.maximum(IY, IX), 0,
                              jnp.where(IY >= IX, 1, 2)).astype(jnp.uint8)
            nD = prev_best + sub
            D_sh = jnp.concatenate([D[:, 1:], jnp.full((B, 1), neg)], axis=1)
            IY_sh = jnp.concatenate([IY[:, 1:], jnp.full((B, 1), neg)], axis=1)
            oc = D_sh + open_
            ec = IY_sh + ext
            nIY = jnp.maximum(oc, ec)
            iy_src = (ec > oc).astype(jnp.uint8)

            ref_ok = ref_col < 4
            # IX closed form (no inner scan): IX[k] = max_{m>=1} nD[k-m] +
            # open + (m-1)*ext.  With g[j] = nD[j] - j*ext this is
            # IX[k] = open + (k-1)*ext + seg_cummax(g)[k-1] where the
            # running max is SEGMENTED at masked reference positions (N or
            # pad = unalignable wall; a deletion run cannot cross it —
            # exact match of the sequential recurrence at lines 127-136)
            karange = jnp.arange(W, dtype=nD.dtype)
            g = jnp.where(ref_ok, nD - karange[None, :] * ext, neg)
            seg = jnp.cumsum((~ref_ok).astype(nD.dtype), axis=1)
            gmax = g
            sh = 1
            while sh < W:
                rolled = jnp.concatenate(
                    [jnp.full((B, min(sh, W)), neg), gmax[:, :W - sh]],
                    axis=1)
                rolled_seg = jnp.concatenate(
                    [jnp.full((B, min(sh, W)), -1.0, dtype=nD.dtype),
                     seg[:, :W - sh]], axis=1)
                gmax = jnp.maximum(
                    gmax, jnp.where(rolled_seg == seg, rolled, neg))
                sh *= 2
            nIX = jnp.concatenate(
                [jnp.full((B, 1), neg),
                 open_ + karange[1:][None, :] * ext - ext + gmax[:, :-1]],
                axis=1)
            nIX = jnp.where(ref_ok, nIX, neg)
            # backtrace bit exactly as the sequential recurrence sets it:
            # ec = IX[k-1] + ext vs oc = D[k-1] + open
            oc = jnp.concatenate(
                [jnp.full((B, 1), neg), nD[:, :-1] + open_], axis=1)
            ec2 = jnp.concatenate(
                [jnp.full((B, 1), neg), nIX[:, :-1] + ext], axis=1)
            ix_src = (ec2 > oc).astype(jnp.uint8)

            ptr = m_src | (iy_src << 2) | (ix_src << 3)
            best = harvest(i, nD, nIY, nIX, best)
            return (nD, nIY, nIX, best), ptr

        best0 = harvest(0, D0, IY0, IX0, best0)
        (D, IY, IX, best), ptrs = jax.lax.scan(
            row, (D0, IY0, IX0, best0),
            (jnp.arange(1, L + 1), read_cols, ref_band))
        pointers = jnp.concatenate(
            [jnp.zeros((1,) + ptrs.shape[1:], jnp.uint8), ptrs]
        ).transpose(1, 0, 2)                                     # [B, L+1, W]
        bs, bk, bst = best
        return bs, bk, bst, pointers

    return forward
