"""Host-side process parallelism for the alignment pipeline.

The reference is thread-ready around its per-read-pair loop (OpenMP pragmas,
commented out in the snapshot — processBAM.cpp:2076; typing uses
`--maxThreads`).  Reads are i.i.d., so the host backend parallelises the
host work (seeding, backtrace, projection, pair selection) across worker
processes, each owning a full numpy ReadAligner built from the compiled
graph package.  Workers are spawned (not forked) and pinned to the CPU:
they never open the accelerator, which one process owns.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys

_WORKER_ALIGNER = None


def pin_worker_to_cpu() -> None:
    """Keep a host worker process off the accelerator."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_platforms", "cpu")


def _init_worker(graph_dir: str, band, kmer_k: int, long_reads: str,
                 decoy_fasta: str = "", map_complete: bool = False):
    global _WORKER_ALIGNER
    pin_worker_to_cpu()
    from ..graph.package import GraphPackage
    from ..utils.config import RunConfig
    from .aligner import ReadAligner
    cfg = RunConfig(long_reads=long_reads, decoy_fasta=decoy_fasta,
                    map_against_complete_genome=map_complete)
    pkg = GraphPackage(graph_dir)
    from .pipeline import build_decoy
    decoy = build_decoy(pkg, cfg)   # cache-hit after the parent built it
    _WORKER_ALIGNER = ReadAligner(pkg, cfg, band=band,
                                  kmer_k=kmer_k, use_jax=False, decoy=decoy)


def _align_chunk(args):
    idx, packed, insert_mean, insert_sd = args
    return idx, pack_aligned_pairs(
        _WORKER_ALIGNER.align_pairs(unpack_read_pairs(packed),
                                    insert_mean, insert_sd))


def _align_unpaired_chunk(args):
    idx, packed = args
    return idx, _WORKER_ALIGNER.align_unpaired(unpack_reads(packed))


def pack_reads(reads):
    """Count + three newline-joined strings instead of a list of FastqRead
    objects: pickling ~100k small dataclasses cost the parent ~0.5 s per
    dispatch at real-PRG scale.  FASTQ/BAM fields never contain newlines.
    The explicit count disambiguates the n==1-with-empty-field case
    (\"\" joins to \"\" for both 0 and 1 reads) and guards truncation."""
    return (len(reads),
            "\n".join(r.name for r in reads),
            "\n".join(r.seq for r in reads),
            "\n".join(r.qual for r in reads))


def unpack_reads(t):
    from ..io.fastq import FastqRead
    n = t[0]
    if n == 0:
        return []
    cols = [s.split("\n") for s in t[1:]]
    for c in cols:
        assert len(c) == n, f"packed read chunk corrupt: {len(c)} != {n}"
    return [FastqRead(nm, sq, q) for nm, sq, q in zip(*cols)]


def pack_read_pairs(pairs):
    return pack_reads([r for p in pairs for r in p])


def unpack_read_pairs(t):
    rs = unpack_reads(t)
    return list(zip(rs[0::2], rs[1::2]))


def pack_chains(chains):
    """Serialise a list of GraphAlignment chains into large arrays (the
    shared layer under pack_aligned_pairs and the align-shard files)."""
    import numpy as np
    n_cols = np.asarray([c.n_columns for c in chains], dtype=np.int64)
    return dict(
        n_cols=n_cols,
        levels=(np.concatenate([c.levels for c in chains])
                if chains else np.zeros(0, np.int64)),
        graph_c=(np.concatenate([c.graph_c for c in chains])
                 if chains else np.zeros(0, np.uint8)),
        seq_c=(np.concatenate([c.seq_c for c in chains])
               if chains else np.zeros(0, np.uint8)),
        seq_qual=(np.concatenate([c.seq_qual for c in chains])
                  if chains else np.zeros(0, np.uint8)),
        mapq_pp=(np.concatenate(
            [c.mapq_per_pos if c.mapq_per_pos is not None
             else np.ones(c.n_columns) for c in chains])
            if chains else np.zeros(0)),
        reverse=np.asarray([c.reverse for c in chains], dtype=bool),
        seq_idx=np.asarray([c.seq_idx for c in chains], dtype=np.int64),
        mapq=np.asarray([c.mapq for c in chains]),
        ll=np.asarray([c.log_likelihood for c in chains]),
        ffr=np.asarray([c.from_first_read for c in chains], dtype=bool),
        first_lv=np.asarray([c.first_level() for c in chains],
                            dtype=np.int64),
        last_lv=np.asarray([c.last_level() for c in chains], dtype=np.int64),
        # per-chain quality fractions computed HERE (in the worker, in
        # parallel, over the already-concatenated arrays) so the typing
        # phase's weighted_ok/fraction_ok batch passes are all cache hits;
        # both batch functions are bit-identical to their lazy forms
        wok=_wok_of(chains),
        fok=_fok_of(chains),
    )


def _wok_of(chains):
    from .alignment import weighted_ok_fractions_batch
    return weighted_ok_fractions_batch(chains)


def _fok_of(chains):
    from .alignment import fraction_ok_batch
    return fraction_ok_batch(chains)


def pack_aligned_pairs(aps):
    """Serialise a list of AlignedPair into a handful of large arrays —
    pickling thousands of small per-chain arrays dominates IPC otherwise."""
    import numpy as np
    d = pack_chains([c for ap in aps for c in (ap.chain1, ap.chain2)])
    d["read_ids"] = "\n".join(ap.read_id for ap in aps)
    d["pair_mapq"] = np.asarray([ap.mapq for ap in aps])
    return d


def _chain_from_pack(d: dict, s: int, e: int, j: int):
    """One GraphAlignment from pack slice [s:e] / chain index j — the
    single construction point shared by unpack_chains and the lazy
    PackedAlignedPairs.chain (divergence here would desynchronise
    worker-unpacked and lazily-materialised chains)."""
    from .alignment import GraphAlignment
    al = GraphAlignment(
        levels=d["levels"][s:e], graph_c=d["graph_c"][s:e],
        seq_c=d["seq_c"][s:e], seq_qual=d["seq_qual"][s:e],
        reverse=bool(d["reverse"][j]), seq_idx=int(d["seq_idx"][j]),
        mapq=float(d["mapq"][j]), mapq_per_pos=d["mapq_pp"][s:e],
        from_first_read=bool(d["ffr"][j]),
        log_likelihood=float(d["ll"][j]))
    al._first_level = int(d["first_lv"][j])
    al._last_level = int(d["last_lv"][j])
    return al


def unpack_chains(d):
    import numpy as np
    offs = np.concatenate([[0], np.cumsum(d["n_cols"])])
    chains = []
    for i in range(len(d["n_cols"])):
        chains.append(_chain_from_pack(d, int(offs[i]), int(offs[i + 1]), i))
    # quality-fraction caches shipped with the pack (absent in pre-existing
    # align-shard files: stays lazy then)
    wok = d.get("wok")
    fok = d.get("fok")
    if wok is not None and fok is not None and len(wok) == len(chains):
        wok_l, fok_l = wok.tolist(), fok.tolist()
        for i, al in enumerate(chains):
            al._wok = wok_l[i]
            al._frac_ok = fok_l[i]
    return chains


def unpack_aligned_pairs(d):
    from .aligner import AlignedPair
    ids = d["read_ids"].split("\n") if d["read_ids"] else []
    chains = unpack_chains(d)
    return [AlignedPair(ids[i], chains[2 * i], chains[2 * i + 1],
                        float(d["pair_mapq"][i]))
            for i in range(len(ids))]


class PackedAlignedPairs:
    """Sequence façade over the packed SoA chain arrays — the align→typing
    seam closed (VERDICT r4 next #1).  The workers' flat chain arrays stay
    live through typing: per-pair/per-chain scalar arrays (level ranges,
    reverse flags, mapQ, weightedOK/fractionOK) are read straight off the
    pack with zero python loops, and `GraphAlignment`/`AlignedPair` objects
    materialise LAZILY — only for the chains a locus actually visits (obs
    extraction) or for explicit consumers (truth evaluation, BAM export).
    Matches the reference's in-memory handoff processBAM.cpp:1788-1923 →
    HLATyper.cpp:933 without the object puff-up in between.

    `pack` keys are exactly `pack_aligned_pairs`'s output; `subset()` and
    `from_chunks()` operate purely on the arrays, so fan-out shipping and
    shard merging never round-trip through objects either."""

    __slots__ = ("pack", "_offs", "_ids", "_pairs", "_chains")

    def __init__(self, pack: dict):
        self.pack = pack
        self._offs = None
        self._ids = None
        self._pairs = None
        self._chains = None

    def __getstate__(self):
        return self.pack      # pickle the arrays, never the lazy caches

    def __setstate__(self, pack):
        self.__init__(pack)

    # ------------------------------------------------------------ plumbing
    @classmethod
    def from_chunks(cls, packs: list[dict]) -> "PackedAlignedPairs":
        """Concatenate per-chunk packs (worker results) into one.  Only
        keys present in EVERY pack are kept: merging align-shard files
        from mixed builds (older shards lack the wok/fok caches) must
        drop the optional caches, not crash — consumers already guard on
        key presence."""
        import numpy as np
        if not packs:
            return cls(pack_aligned_pairs([]))
        if len(packs) == 1:
            return cls(packs[0])
        keys = set(packs[0])
        for p in packs[1:]:
            keys &= set(p)
        missing = {"n_cols", "levels", "pair_mapq", "read_ids"} - keys
        if missing:
            raise ValueError(f"align packs missing required keys: "
                             f"{sorted(missing)}")
        out = {k: np.concatenate([p[k] for p in packs])
               for k in keys if k != "read_ids"}
        out["read_ids"] = "\n".join(
            p["read_ids"] for p in packs if p["read_ids"])
        return cls(out)

    @property
    def offsets(self):
        import numpy as np
        if self._offs is None:
            self._offs = np.concatenate(
                [[0], np.cumsum(self.pack["n_cols"])])
        return self._offs

    @property
    def read_ids(self) -> list[str]:
        if self._ids is None:
            s = self.pack["read_ids"]
            self._ids = s.split("\n") if s else []
        return self._ids

    def __len__(self) -> int:
        return len(self.pack["pair_mapq"])

    # ------------------------------------------------- lazy materialisation
    def chain(self, j: int):
        """GraphAlignment for chain index j (pair i's mates are 2i, 2i+1),
        materialised on first touch and cached — obs extraction revisits
        the same chains across typing passes, and `_chain_records` caches
        live on the object."""
        if self._chains is None:
            self._chains = [None] * (2 * len(self))
        al = self._chains[j]
        if al is None:
            d = self.pack
            offs = self.offsets
            al = _chain_from_pack(d, int(offs[j]), int(offs[j + 1]), j)
            wok, fok = d.get("wok"), d.get("fok")
            if wok is not None and fok is not None \
                    and len(wok) == 2 * len(self):
                al._wok = float(wok[j])
                al._frac_ok = float(fok[j])
            self._chains[j] = al
        return al

    def __getitem__(self, i):
        from .aligner import AlignedPair
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self._pairs is None:
            self._pairs = [None] * n
        ap = self._pairs[i]
        if ap is None:
            ap = AlignedPair(self.read_ids[i], self.chain(2 * i),
                             self.chain(2 * i + 1),
                             float(self.pack["pair_mapq"][i]))
            self._pairs[i] = ap
        return ap

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------- array surgery
    def subset(self, idx) -> "PackedAlignedPairs":
        """New PackedAlignedPairs with pairs `idx` (any order) — pure array
        gathers, no object round-trip."""
        import numpy as np
        idx = np.asarray(idx, dtype=np.int64)
        d = self.pack
        ci = np.empty(2 * len(idx), dtype=np.int64)
        ci[0::2] = 2 * idx
        ci[1::2] = 2 * idx + 1
        offs = self.offsets
        lens = d["n_cols"][ci]
        starts = offs[ci]
        total = int(lens.sum())
        ends_out = np.cumsum(lens)
        col_idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(ends_out - lens, lens)
                   + np.repeat(starts, lens))
        ids = self.read_ids
        out = dict(
            n_cols=lens,
            levels=d["levels"][col_idx], graph_c=d["graph_c"][col_idx],
            seq_c=d["seq_c"][col_idx], seq_qual=d["seq_qual"][col_idx],
            mapq_pp=d["mapq_pp"][col_idx],
            reverse=d["reverse"][ci], seq_idx=d["seq_idx"][ci],
            mapq=d["mapq"][ci], ll=d["ll"][ci], ffr=d["ffr"][ci],
            first_lv=d["first_lv"][ci], last_lv=d["last_lv"][ci],
            read_ids="\n".join(ids[i] for i in idx.tolist()),
            pair_mapq=d["pair_mapq"][idx],
        )
        for k in ("wok", "fok"):
            if k in d:
                out[k] = d[k][ci]
        return PackedAlignedPairs(out)


def spawn_safe() -> bool:
    """Spawned children re-execute the __main__ module; with an interactive /
    stdin main module that crash-loops.  Only parallelise when safe, and
    never from inside a worker (a child re-running unguarded __main__ code
    must not spawn grandchildren)."""
    import sys
    if os.environ.get("HLA_LA_IN_WORKER"):
        return False
    main = sys.modules.get("__main__")
    f = getattr(main, "__file__", None)
    return bool(f) and os.path.exists(f)


class ParallelAligner:
    """Drop-in align_pairs/align_unpaired over a process pool."""

    def __init__(self, graph_dir: str, n_workers: int,
                 band: int | None = None,
                 kmer_k: int = 20, long_reads: str = "",
                 decoy_fasta: str = "", map_complete: bool = False):
        if not spawn_safe():
            raise RuntimeError(
                "ParallelAligner needs a file-backed __main__ module "
                "(multiprocessing spawn); use the serial ReadAligner")
        ctx = mp.get_context("spawn")
        self.n_workers = max(1, n_workers)
        os.environ["HLA_LA_IN_WORKER"] = "1"   # inherited by children
        try:
            self.pool = ctx.Pool(self.n_workers, initializer=_init_worker,
                                 initargs=(graph_dir, band, kmer_k,
                                           long_reads, decoy_fasta,
                                           map_complete))
        finally:
            del os.environ["HLA_LA_IN_WORKER"]

    def align_pairs(self, pairs, insert_mean, insert_sd, truth=None):
        if not pairs:
            return []
        # ~6 chunks per worker: tail-imbalance costs more than the extra
        # IPC (measured at 3M-level scale, r2)
        chunk = max(256, -(-len(pairs) // (self.n_workers * 6)))
        chunks = [pairs[i:i + chunk] for i in range(0, len(pairs), chunk)]
        # imap_unordered so the parent unpacks each chunk while workers are
        # still aligning the rest (pool.map would leave the parent idle and
        # then unpack everything serially); chunk ids restore the order
        slots = [None] * len(chunks)
        for idx, res in self.pool.imap_unordered(
                _align_chunk,
                [(i, pack_read_pairs(c), insert_mean, insert_sd)
                 for i, c in enumerate(chunks)]):
            slots[idx] = res
        # the packed chunk arrays stay live end-to-end (PackedAlignedPairs):
        # GraphAlignment objects materialise lazily, only where consumed
        out = PackedAlignedPairs.from_chunks(slots)
        if truth is not None:
            by_id = {ap.read_id: ap for ap in out}
            for r1, r2 in pairs:
                ap = by_id.get(r1.name)
                if ap is None:
                    continue
                truth.evaluate(f"{r1.name}/1",
                               ap.chain1.aligned_levels_per_base(len(r1.seq)),
                               ap.chain1.reverse)
                truth.evaluate(f"{r2.name}/2",
                               ap.chain2.aligned_levels_per_base(len(r2.seq)),
                               ap.chain2.reverse)
        return out

    def align_unpaired(self, reads, truth=None):
        if not reads:
            return []
        chunk = max(256, -(-len(reads) // (self.n_workers * 2)))
        chunks = [reads[i:i + chunk] for i in range(0, len(reads), chunk)]
        slots = [None] * len(chunks)
        for idx, res in self.pool.imap_unordered(
                _align_unpaired_chunk,
                [(i, pack_reads(c)) for i, c in enumerate(chunks)]):
            slots[idx] = res
        out = [al for res in slots for al in res]
        if truth is not None:
            for r, al in zip(reads, out):
                if al is not None:
                    truth.evaluate(r.name,
                                   al.aligned_levels_per_base(len(r.seq)),
                                   al.reverse)
        return out

    def close(self):
        self.pool.close()
        self.pool.join()
