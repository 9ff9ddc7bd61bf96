"""Device kernels for the HLA typing likelihood model.

Two hot ops (SURVEY.md §7 'hard part #2'; reference: HLATyper.cpp:2000-2364):

1. cluster_read_ll — per-cluster x per-read log-likelihoods.  The reference
   loops clusters x reads x positions over strings (HLATyper.cpp:2089-2277).
   Dense form: each read's pileup observations are lowered to a dense
   [R, J, 6] tensor of per-channel log-likelihood contributions (channels =
   cluster column being A/C/G/T/gap/other); cluster sequences become a one-hot
   [C, J, 6].  Then LL = onehot . T — ONE matmul of shape
   [C, J*6] @ [J*6, R].  Mismatch counts come from a second matmul.

2. pair_ll_reduction — diploid pair log-likelihoods
   LL[c1,c2] = sum_r logavg(L[c1,r], L[c2,r])  (HLATyper.cpp:2280-2364,
   the reference's only OpenMP-parallel loop).  O(C^2 R) elementwise work,
   computed in R-chunks (numpy, the native kernel, or an XLA scan).
"""

from __future__ import annotations

import numpy as np

LOG_HALF = float(np.log(0.5))

# channel order for the one-hot encoding of cluster columns
CH_A, CH_C, CH_G, CH_T, CH_GAP, CH_OTHER = range(6)
_CHANNEL = np.full(256, CH_OTHER, dtype=np.int8)
for ch, b in ((CH_A, "A"), (CH_C, "C"), (CH_G, "G"), (CH_T, "T"),
              (CH_GAP, "_")):
    _CHANNEL[ord(b)] = ch


def cluster_onehot(cluster_seqs: list[str]) -> np.ndarray:
    """[C, J, 6] float32 one-hot of cluster column characters."""
    C = len(cluster_seqs)
    J = len(cluster_seqs[0])
    codes = np.frombuffer("".join(cluster_seqs).encode(), dtype=np.uint8
                          ).reshape(C, J)
    onehot = np.zeros((C, J, 6), dtype=np.float32)
    ch = _CHANNEL[codes]
    for c in range(6):
        onehot[:, :, c] = ch == c
    return onehot


def cluster_channel_codes(cluster_seqs: list[str]) -> np.ndarray:
    """[C, J] int8 channel code (CH_*) of each cluster column."""
    C = len(cluster_seqs)
    J = len(cluster_seqs[0])
    codes = np.frombuffer("".join(cluster_seqs).encode(), dtype=np.uint8
                          ).reshape(C, J)
    return _CHANNEL[codes]


def cluster_delta_plan(ch: np.ndarray):
    """Sparse-delta evaluation plan for cluster_read_ll.

    Exploits that allele clusters of one locus are near-identical (the
    reference's segment matrices differ in a few % of columns,
    HLATyper.cpp:1198-1299): pick the per-column consensus channel as a
    reference row, so LL[c] = LL_ref + sum over the cluster's few
    differing columns.  Returns (ref[J] consensus channel,
    base_cols[J] = j*6+ref, plus_cols/minus_cols[ndiff] flat [J*6]
    indices, starts[C+1] per-cluster diff ranges)."""
    C, J = ch.shape
    hist = np.zeros((J, 6), dtype=np.int32)
    for c in range(6):
        hist[:, c] = (ch == c).sum(axis=0, dtype=np.int32)
    ref = hist.argmax(axis=1).astype(np.int8)
    base_cols = (np.arange(J, dtype=np.int64) * 6 + ref)
    dc, dj = np.nonzero(ch != ref[None, :])
    plus_cols = dj * 6 + ch[dc, dj]
    minus_cols = dj * 6 + ref[dj]
    starts = np.searchsorted(dc, np.arange(C + 1)).astype(np.int64)
    return ref, base_cols, plus_cols.astype(np.int64), \
        minus_cols.astype(np.int64), starts


def cluster_read_ll_delta_numpy(ch: np.ndarray, contrib_T: np.ndarray,
                                mismatch_T: np.ndarray, plan=None,
                                out_ll=None, out_mm=None
                                ) -> tuple[np.ndarray, np.ndarray]:
    """Reference (numpy) sparse-delta cluster_read_ll.

    contrib_T / mismatch_T are the TRANSPOSED [J*6, R] tensors (rows
    contiguous over reads).  Same math as the dense matmul up to f32
    summation order (parity locked by tests/test_imgt_scale.py); base
    rows accumulate in f64."""
    C, J = ch.shape
    R = contrib_T.shape[1]
    ref, base_cols, plus_cols, minus_cols, starts = \
        plan if plan is not None else cluster_delta_plan(ch)
    out = []
    for T, M in ((contrib_T, out_ll), (mismatch_T, out_mm)):
        base = T[base_cols].sum(axis=0, dtype=np.float64)       # [R]
        if M is None:
            M = np.empty((C, R), dtype=np.float32)
        acc = np.empty(R, dtype=np.float64)
        for c in range(C):
            k0, k1 = starts[c], starts[c + 1]
            if k1 > k0:
                # accumulate per-k (plus - minus) deltas onto base IN THE
                # NATIVE KERNEL'S ORDER (acc += p_k - m_k), so the f64
                # rounding sequence — and therefore the f32 result — is
                # bit-identical to hla_cluster_ll_delta for any k-count
                # (a sum(plus) - sum(minus) form rounds differently)
                np.copyto(acc, base)
                for k in range(int(k0), int(k1)):
                    acc += (T[plus_cols[k]].astype(np.float64)
                            - T[minus_cols[k]].astype(np.float64))
                M[c] = acc.astype(np.float32)
            else:
                M[c] = base.astype(np.float32)
        out.append(M)
    return out[0], out[1]


def cluster_read_ll_delta(ch: np.ndarray, contrib_T: np.ndarray,
                          mismatch_T: np.ndarray, plan=None,
                          out_ll=None, out_mm=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Sparse-delta cluster_read_ll: native threaded kernel when available,
    numpy reference otherwise.  See cluster_delta_plan.  out_ll/out_mm:
    optional preallocated [C, R] f32 outputs (column slices of a wider
    matrix are fine)."""
    from .. import native
    if plan is None:
        plan = cluster_delta_plan(ch)
    ref, base_cols, plus_cols, minus_cols, starts = plan
    out = native.cluster_ll_delta(contrib_T, mismatch_T, base_cols,
                                  plus_cols, minus_cols, starts,
                                  out_ll=out_ll, out_mm=out_mm)
    if out is not None:
        return out
    return cluster_read_ll_delta_numpy(ch, contrib_T, mismatch_T, plan,
                                       out_ll=out_ll, out_mm=out_mm)


def cluster_read_ll(onehot: np.ndarray, contrib: np.ndarray,
                    mismatch: np.ndarray, backend: str = "numpy"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """LL[c, r] and mismatches[c, r] via two matmuls.

    onehot:   [C, J, 6]
    contrib:  [R, J, 6] per-read per-column per-channel log-lik contributions
    mismatch: [R, J, 6] per-channel mismatch indicator contributions
    """
    C, J, _ = onehot.shape
    R = contrib.shape[0]
    A = onehot.reshape(C, J * 6)
    Bc = contrib.reshape(R, J * 6).T
    Bm = mismatch.reshape(R, J * 6).T
    if backend != "jax":
        # "auto" -> BLAS: the [C, J6] x [J6, R] matmuls are small relative
        # to host->device transfer of the contribution tensors; the device
        # path only pays off when explicitly requested on real batches
        return A @ Bc, A @ Bm
    import jax
    import jax.numpy as jnp
    # full f32 products: on a GPU the default f32 matmul may run in TF32,
    # which keeps about three decimal digits of the LL values
    hi = jax.lax.Precision.HIGHEST
    ll = jnp.dot(jnp.asarray(A), jnp.asarray(Bc),
                 preferred_element_type=jnp.float32, precision=hi)
    mm = jnp.dot(jnp.asarray(A), jnp.asarray(Bm),
                 preferred_element_type=jnp.float32, precision=hi)
    return np.asarray(ll), np.asarray(mm)


# ------------------------------------------------------------ pair reduction
def pair_ll_reduction_numpy(L: np.ndarray, chunk: int = 256) -> np.ndarray:
    """LL[c1, c2] = sum_r log((exp(L[c1,r]) + exp(L[c2,r])) / 2), computed in
    read chunks.  Returns the full [C, C] matrix (symmetric)."""
    C, R = L.shape
    out = np.zeros((C, C), dtype=np.float64)
    L = L.astype(np.float64)
    for lo in range(0, R, chunk):
        chunk_L = L[:, lo:lo + chunk]                    # [C, Rc]
        a = chunk_L[:, None, :]                          # [C, 1, Rc]
        b = chunk_L[None, :, :]                          # [1, C, Rc]
        hi = np.maximum(a, b)
        lo_ = np.minimum(a, b)
        out += (LOG_HALF + hi + np.log1p(np.exp(lo_ - hi))).sum(axis=2)
    return out


import functools


@functools.lru_cache(maxsize=16)
def make_pair_ll_jax(C: int, R: int, chunk: int = 512):
    """jit-compiled pair reduction: lax.scan over read chunks of the shared
    [C, R] likelihood matrix.  Decomposition:
      logavg(a,b) = (a+b)/2 + |a-b|/2 + log1p(exp(-|a-b|)) + log(1/2)
    where sum_r (a+b)/2 is a rank-1 term from row sums (cheap) and the rest is
    elementwise over [C, C, chunk] tiles."""
    import jax
    import jax.numpy as jnp

    n_chunks = -(-R // chunk)
    Rpad = n_chunks * chunk

    @jax.jit
    def run(L):
        # device computes only the difference part (bounded magnitudes keep
        # f32 precise); the rank-1 (a+b)/2 part is added by the caller in f64.
        Lp = jnp.pad(L, ((0, 0), (0, Rpad - R)))

        def body(acc, xs):
            blk = xs                                      # [C, chunk]
            d = jnp.abs(blk[:, None, :] - blk[None, :, :])
            acc = acc + (0.5 * d + jnp.log1p(jnp.exp(-d))).sum(axis=2)
            return acc, None

        blocks = Lp.reshape(C, n_chunks, chunk).transpose(1, 0, 2)
        acc, _ = jax.lax.scan(body, jnp.zeros((C, C), L.dtype), blocks)
        return acc
    return run


def pair_ll_reduction(L: np.ndarray, backend: str = "auto",
                      chunk: int = 256) -> np.ndarray:
    if backend == "auto":
        # small jobs keep the numpy reference path (byte-stable outputs);
        # big ones go to the native AVX-512 kernel or, without the native
        # lib, the XLA scan
        C, R = L.shape if L.ndim == 2 else (0, 0)
        if C * C * R <= 1e7:
            backend = "numpy"
        else:
            from .. import native
            backend = "native" if native.available() else \
                ("jax" if C * C * R > 1e8 else "numpy")
    if backend == "native":
        from .. import native
        out = native.pair_ll(L)
        if out is not None:
            return out
        backend = "jax"          # lib missing: fall through
    if backend == "numpy" or L.size == 0:
        return pair_ll_reduction_numpy(L, chunk)
    if backend == "sharded":
        from ..parallel.mesh import pair_ll_reduction_sharded
        return pair_ll_reduction_sharded(L)
    C, R = L.shape
    # bound the [C, C, chunk] intermediate to ~1.3e8 f32 (0.5 GB)
    chunk = min(chunk, max(R, 1), max(1, int(1.3e8 // max(C * C, 1))))
    n_chunks = -(-R // chunk)
    Rpad = n_chunks * chunk
    run = make_pair_ll_jax(C, R, chunk)
    acc = np.asarray(run(L.astype(np.float32)), dtype=np.float64)
    rowsum = L.astype(np.float64).sum(axis=1)
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    # padded reads (value 0) contribute log(2) each to acc and LOG_HALF each
    # to the per-read constant: log2 + LOG_HALF = 0, so using Rpad cancels
    return base + acc + LOG_HALF * Rpad


def pair_min_mismatch_row(mm: np.ndarray, c1: int) -> np.ndarray:
    """Mismatches_min for pairs (c1, *): sum_r min(m[c1,r], m[c,r])
    (HLATyper.cpp:2337-2340, needed only for the best-guess row).

    Chunked over clusters with a small reused temp: the naive broadcast
    allocates a full [C, R] copy (~150 MB at IMGT scale) whose page
    faults cost seconds on shared VMs.  Row sums are computed per row
    either way, so the result is bit-identical to the one-shot form."""
    C, R = mm.shape
    out = np.empty(C, dtype=mm.dtype)
    row = mm[c1][None, :]
    chunk = max(1, int(4e6 // max(R, 1)))
    buf = np.empty((min(chunk, C), R), dtype=mm.dtype)
    for lo in range(0, C, chunk):
        hi = min(lo + chunk, C)
        b = buf[:hi - lo]
        np.minimum(row, mm[lo:hi], out=b)
        out[lo:hi] = b.sum(axis=1)
    return out
