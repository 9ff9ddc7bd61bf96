"""Multi-device scale-out: mesh construction and sharded compute steps.

The reference has no distributed backend — its parallelism is OpenMP over
allele-cluster pairs (HLATyper.cpp:2293-2364) and thread-ready (but serial)
per-read loops (SURVEY.md §2.3).  The device replacement:

  * axis "data"  — reads are i.i.d. work items; read batches and the [R, J6]
    pileup tensors shard across it; per-pair partial likelihood sums are
    reduced with psum.
  * axis "model" — allele clusters shard across it for the O(C^2 R) pair
    reduction; the [C_local, R_local] likelihood tile is all-gathered over
    "model" (C is small) so each device owns a [C/m, C] pair tile.

No parameter sharding is ever needed: the "model" (graph + allele matrices)
is replicated per host.
"""

from __future__ import annotations

from functools import partial

import numpy as np

LOG_HALF = float(np.log(0.5))


def make_mesh(n_data: int, n_model: int = 1, devices=None):
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    need = n_data * n_model
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    dev = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(dev, ("data", "model"))


def sharded_typing_step(mesh):
    """Returns jitted fn(onehot [C, K], contrib [R, K])
    -> (pair_LL [C, C], marginal [C]) with C sharded over "model" and R over
    "data"; psum over "data" completes the pair reduction."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    n_model = mesh.shape["model"]

    @partial(shard_map, mesh=mesh, check_vma=False,
             in_specs=(P("model", None), P("data", None)),
             out_specs=(P("model", None), P("model")))
    def step(onehot_l, contrib_l):
        # [C/m, K] x [K, R/d] -> local likelihood tile
        ll_l = jnp.dot(onehot_l, contrib_l.T,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)  # [C/m, R/d]
        # full-C view of the local reads for the pair tile
        ll_full = jax.lax.all_gather(ll_l, "model", axis=0,
                                     tiled=True)             # [C, R/d]
        a = ll_l[:, None, :]                                 # [C/m, 1, R/d]
        b = ll_full[None, :, :]
        d = jnp.abs(a - b)
        hi = jnp.maximum(a, b)
        pair_partial = (hi + jnp.log1p(jnp.exp(-d))
                        + jnp.float32(LOG_HALF)).sum(axis=2)  # [C/m, C]
        pair = jax.lax.psum(pair_partial, "data")
        # REAL pair-posterior marginal (HLATyper.cpp:2409-2538): softmax
        # over the UNORDERED pairs (upper triangle incl. diagonal — the
        # full symmetric matrix would count every heterozygous pair twice
        # in the normaliser, inflating het-pair posteriors), marginal per
        # cluster = mass of every pair containing it (diagonal once)
        pair_full = jax.lax.all_gather(pair, "model", axis=0,
                                       tiled=True)            # [C, C]
        c_full = pair_full.shape[0]
        triu = (jnp.arange(c_full)[:, None]
                <= jnp.arange(c_full)[None, :])
        post = jnp.where(triu, jnp.exp(pair_full - pair_full.max()), 0.0)
        post = post / post.sum()
        marg_full = (post.sum(axis=1) + post.sum(axis=0)
                     - jnp.diag(post))                        # [C]
        m_idx = jax.lax.axis_index("model")
        c_local = pair.shape[0]
        marg = jax.lax.dynamic_slice(marg_full, (m_idx * c_local,),
                                     (c_local,))              # [C/m]
        return pair, marg

    @jax.jit
    def run(onehot, contrib):
        return step(onehot, contrib)

    return run


def sharded_align_step(mesh, L: int, W: int, full_outputs: bool = False):
    """Returns jitted fn(reads [B, L], lens [B], refs [B, L+W]) sharded over
    "data" (replicated over "model").  full_outputs=True returns the
    complete NW forward tuple (scores, end_k, end_state, pointers) so the
    production host backtrace can consume it; False returns scores only."""
    import jax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from ..device import nw_forward

    fwd = nw_forward(L, W)

    out_specs = ((P("data"), P("data"), P("data"), P("data", None, None))
                 if full_outputs else P("data"))

    @partial(shard_map, mesh=mesh, check_vma=False,
             in_specs=(P("data", None), P("data"), P("data", None)),
             out_specs=out_specs)
    def step(reads_l, lens_l, refs_l):
        s, ek, es, ptr = fwd(reads_l, lens_l, refs_l)
        if full_outputs:
            return s, ek, es, ptr
        return s

    return jax.jit(step)


class ShardedNW:
    """Production device-sharded banded-NW forward: pads the batch to the
    data-axis size and runs the jitted sharded step (SURVEY §2.3's data-
    parallel read mapping).  Drop-in for ReadAligner's single-device path."""

    def __init__(self, mesh, L: int, W: int):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.L, self.W = L, W
        self.step = sharded_align_step(mesh, L, W, full_outputs=True)

    def __call__(self, reads, lens, refs):
        import numpy as np
        B = reads.shape[0]
        Bp = -(-B // self.n_data) * self.n_data
        if Bp != B:
            pad = Bp - B
            reads = np.concatenate(
                [reads, np.full((pad, self.L), 4, dtype=reads.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, dtype=lens.dtype)])
            refs = np.concatenate(
                [refs, np.full((pad, self.L + self.W), 4, dtype=refs.dtype)])
        s, ek, es, ptr = self.step(reads, lens, refs)
        return (np.asarray(s)[:B], np.asarray(ek)[:B], np.asarray(es)[:B],
                np.asarray(ptr)[:B])


def full_step(mesh, L: int, W: int):
    """The complete sharded 'training step' analogue: banded-NW scoring of a
    read batch (data-parallel) + cluster-likelihood matmul + C^2 pair
    reduction (model x data) in one jitted program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from ..device import nw_forward

    fwd = nw_forward(L, W)

    @partial(shard_map, mesh=mesh, check_vma=False,
             in_specs=(P("data", None), P("data"), P("data", None),
                       P("model", None), P("data", None)),
             out_specs=(P("data"), P("model", None)))
    def step(reads_l, lens_l, refs_l, onehot_l, contrib_l):
        scores, _, _, _ = fwd(reads_l, lens_l, refs_l)
        ll_l = jnp.dot(onehot_l, contrib_l.T,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        ll_full = jax.lax.all_gather(ll_l, "model", axis=0, tiled=True)
        a = ll_l[:, None, :]
        b = ll_full[None, :, :]
        d = jnp.abs(a - b)
        pair_partial = (jnp.maximum(a, b) + jnp.log1p(jnp.exp(-d))
                        + jnp.float32(LOG_HALF)).sum(axis=2)
        pair = jax.lax.psum(pair_partial, "data")
        return scores, pair

    return jax.jit(step)


def pair_ll_reduction_sharded(L: np.ndarray, mesh=None) -> np.ndarray:
    """Multi-device C^2 pair reduction: clusters shard over "model", reads
    over "data"; each device owns a [C/m, C] pair tile of its read shard and
    psum over "data" completes the sum (the distributed replacement for the
    reference's OpenMP loop, HLATyper.cpp:2293-2364).

    Numerics identical to ops/pair_ll.pair_ll_reduction(backend="jax"):
    the rank-1 0.5*(rowsum+rowsum) term is added host-side in f64; the
    device computes sum_r 0.5*|a-b| + log1p(exp(-|a-b|)) in f32; zero-padded
    reads contribute log(2) each, cancelled by LOG_HALF per padded read."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    if mesh is None:
        n = len(jax.devices())
        n_model = 2 if n % 2 == 0 and n > 2 else 1
        mesh = make_mesh(n // n_model, n_model)
    d = mesh.shape["data"]
    m = mesh.shape["model"]
    C, R = L.shape
    Cp = -(-C // m) * m
    local_C = Cp // m
    # tile/stream (SURVEY §7(d)) holds on the mesh too: scan read chunks
    # so the per-device [C/m, C, chunk] intermediate stays ~0.5 GB — at
    # IMGT scale (C=2200, R=16k) the unchunked broadcast was ~40 GB/device
    chunk = min(512, max(1, int(1.3e8 // max(local_C * Cp, 1))))
    n_chunks = max(1, -(-R // (d * chunk)))
    Rp = n_chunks * d * chunk
    Lp = np.zeros((Cp, Rp), dtype=np.float32)
    Lp[:C, :R] = L

    @partial(shard_map, mesh=mesh, check_vma=False,
             in_specs=(P("model", "data"),), out_specs=P("model", None))
    def step(L_l):                                     # [C/m, R/d]
        L_f = jax.lax.all_gather(L_l, "model", axis=0, tiled=True)  # [C,R/d]
        bl = L_l.reshape(local_C, n_chunks, chunk).transpose(1, 0, 2)
        bf = L_f.reshape(Cp, n_chunks, chunk).transpose(1, 0, 2)

        def body(acc, xs):
            a, b = xs
            diff = jnp.abs(a[:, None, :] - b[None, :, :])
            acc = acc + (0.5 * diff + jnp.log1p(jnp.exp(-diff))).sum(axis=2)
            return acc, None

        part, _ = jax.lax.scan(body, jnp.zeros((local_C, Cp), jnp.float32),
                               (bl, bf))
        return jax.lax.psum(part, "data")              # [C/m, C]

    acc = np.asarray(jax.jit(step)(Lp), dtype=np.float64)[:C, :C]
    rowsum = L.astype(np.float64).sum(axis=1)
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    return base + acc + LOG_HALF * Rp
