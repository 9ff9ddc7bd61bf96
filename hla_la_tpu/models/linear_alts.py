"""Linear-ALT typing (the KIR module).

Reference: linearALTs/linearALTs.{h,cpp} — typing against a panel of
equal-length linear ALT haplotypes: reads are extracted per region, mapped to
the panel, and a diploid haplotype-pair likelihood model picks the best pair
(`haplotypeLikelihoods`, linearALTs.h:29); reads can also be assigned to genes
by interval overlap (`reads2Genes`, linearALTs.h:30).

Form here: the per-read x per-haplotype log-likelihood matrix comes
from the same batched banded-NW kernel as the HLA path, and the diploid pair
reduction reuses ops/pair_ll (the C^2 kernel) with haplotypes as "clusters".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fastq import FastqRead
from ..mapping.kmer_index import KmerIndex
from ..mapping.seeder import Seeder
from ..ops.banded_nw import banded_nw_backtrace, banded_nw_forward
from ..ops.pair_ll import pair_ll_reduction
from ..sim.read_sim import revcomp
from ..utils.phred import phred_to_p_correct_table

_ENC = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENC[b] = i
    _ENC[b + 32] = i


@dataclass
class LinearALTsResult:
    hap1: str
    hap2: str
    posterior: float
    pair_ll: np.ndarray          # [H, H]
    hap_names: list[str]
    read_gene_counts: dict[str, int]


class LinearALTsTyper:
    def __init__(self, haplotypes: dict[str, str], band: int = 32,
                 kmer_k: int = 20,
                 genes: dict[str, tuple[int, int]] | None = None,
                 backend: str = "numpy", n_is_gap: bool = False):
        """haplotypes: {name: sequence} — the equal-length ALT panel
        (equal length is the reference's convention; not required here).
        genes: {gene: (start, stop)} intervals in panel coordinates.

        Alignment gaps ('-'/'_'/'.', plus 'N' when `n_is_gap` — the
        KirPackage equal-length block stores gaps as N) are STRIPPED for
        seeding/alignment/scoring: a gap is known absence of sequence, and
        scoring reads against gap placeholders made a haplotype's own
        deletion an unalignable NW wall — reads spanning it scored better
        on OTHER haplotypes, flipping true homozygous calls to confident
        wrong hets (caught by the randomized soak; regression test
        test_linear_alts.py::test_deletion_haplotype_homozygous_call).
        Anchors/insert distances live in ungapped coordinates; gene
        interval checks translate back to panel coordinates per
        haplotype."""
        self.names = list(haplotypes)
        self.seqs = [haplotypes[n] for n in self.names]
        gap_chars = "-_." + ("N" if n_is_gap else "")
        self.useqs: list[str] = []
        self.u2a: list[np.ndarray] = []
        for s in self.seqs:
            arr = np.frombuffer(s.upper().encode(), dtype=np.uint8)
            keep = ~np.isin(arr, np.frombuffer(gap_chars.encode(),
                                               dtype=np.uint8))
            self.useqs.append(arr[keep].tobytes().decode())
            self.u2a.append(np.flatnonzero(keep))
        self.index = KmerIndex.build(
            dict(zip(self.names, self.useqs)), k=kmer_k)
        self.seeder = Seeder(self.index)
        self.band = band
        self.genes = genes or {}
        self.backend = backend
        self._table = phred_to_p_correct_table(conservative_cap=0.999,
                                               floor=1e-5)

    def _panel_pos(self, hap_idx: int, upos: int) -> int:
        """Ungapped position -> panel (aligned) coordinate."""
        m = self.u2a[hap_idx]
        if len(m) == 0:
            return 0
        return int(m[min(max(upos, 0), len(m) - 1)])

    # --------------------------------------------------------------- scoring
    def _read_ll_row(self, read: FastqRead, unaligned_ll: float
                     ) -> tuple[np.ndarray, tuple[int, int] | None,
                                np.ndarray]:
        """LL of the read under each panel haplotype (best alignment per
        haplotype; `unaligned_ll` where no seed) + best (hap, ref_start) +
        per-haplotype best anchor position ([H] int64, -1 = unseeded)."""
        H = len(self.names)
        row = np.full(H, unaligned_ll, dtype=np.float64)
        pos_row = np.full(H, -1, dtype=np.int64)
        cands = self.seeder.candidates(read.seq)
        best_anchor = None
        best_ll = -np.inf
        if not cands:
            return row, None, pos_row
        L = len(read.seq)
        W = self.band
        reads_arr = np.zeros((len(cands), L), dtype=np.uint8)
        lens_arr = np.full(len(cands), L, dtype=np.int64)
        refs_arr = np.full((len(cands), L + W), 4, dtype=np.uint8)
        metas = []
        for bi, c in enumerate(cands):
            oriented = revcomp(read.seq) if c.reverse else read.seq
            qual = read.qual[::-1] if c.reverse else read.qual
            reads_arr[bi] = _ENC[np.frombuffer(oriented.encode(), np.uint8)]
            hap = self.useqs[c.seq_idx].encode()
            lo = c.ref_start - W // 2
            src_lo, src_hi = max(lo, 0), min(lo + L + W, len(hap))
            if src_hi > src_lo:
                refs_arr[bi, src_lo - lo:src_hi - lo] = _ENC[
                    np.frombuffer(hap[src_lo:src_hi], np.uint8)]
            metas.append((c, oriented, qual, lo))
        scores, end_k, end_state, pointers = banded_nw_forward(
            reads_arr, lens_arr, refs_arr)
        for bi, (c, oriented, qual, lo) in enumerate(metas):
            if scores[bi] <= -1e29:
                continue
            ops = banded_nw_backtrace(pointers[bi], L, int(end_k[bi]),
                                      int(end_state[bi]))
            ll = self._score_ops(ops, oriented, qual,
                                 self.useqs[c.seq_idx], lo)
            if ll > row[c.seq_idx]:
                row[c.seq_idx] = ll
                pos_row[c.seq_idx] = lo + W // 2
            if ll > best_ll:
                best_ll = ll
                best_anchor = (c.seq_idx, lo + W // 2)
        return row, best_anchor, pos_row

    def _score_ops(self, ops, oriented: str, qual: str, hap: str,
                   window_start: int) -> float:
        log_ins = np.log(0.001) + np.log(0.25)
        log_del = np.log(0.001)
        log_mm = np.log(1 - 0.002)
        ll = 0.0
        for op, rp, ref_p in ops:
            if op == 0:
                p = window_start + ref_p
                pc = float(self._table[ord(qual[rp])])
                if 0 <= p < len(hap) and hap[p] == oriented[rp]:
                    ll += log_mm + np.log(pc)
                else:
                    ll += log_mm + np.log((1 - pc) / 3.0)
            elif op == 1:
                ll += log_ins
            else:
                ll += log_del
        return ll

    # ---------------------------------------------------------------- typing
    def haplotype_likelihoods(self, reads: list[FastqRead]
                              ) -> tuple[np.ndarray, list]:
        """[H, R] log-likelihood matrix + per-read best anchors."""
        H = len(self.names)
        rows = []
        anchors = []
        for r in reads:
            unaligned = len(r.seq) * np.log(0.25)
            row, anchor, _pos = self._read_ll_row(r, unaligned)
            rows.append(row)
            anchors.append(anchor)
        L = (np.stack(rows).T if rows
             else np.zeros((H, 0), dtype=np.float64))
        return L, anchors

    def type_diploid(self, reads: list[FastqRead]) -> LinearALTsResult:
        """Diploid ALT-pair model (processCollectedAlignments /
        haplotypeLikelihoods semantics): LL(h1,h2) = sum_r logavg."""
        L, anchors = self.haplotype_likelihoods(reads)
        pair = pair_ll_reduction(L, backend=self.backend)
        H = len(self.names)
        iu = np.triu_indices(H)
        vals = pair[iu]
        best = int(np.argmax(vals))
        h1, h2 = int(iu[0][best]), int(iu[1][best])
        p = np.exp(vals - vals.max())
        p /= p.sum()

        gene_counts: dict[str, int] = {g: 0 for g in self.genes}
        for anchor in anchors:
            if anchor is None:
                continue
            hi_, pos = anchor
            pos = self._panel_pos(hi_, pos)
            for g, (lo, hi) in self.genes.items():
                if lo <= pos < hi:
                    gene_counts[g] += 1
        return LinearALTsResult(
            hap1=self.names[h1], hap2=self.names[h2],
            posterior=float(p[best]), pair_ll=pair,
            hap_names=self.names, read_gene_counts=gene_counts)

    def estimate_insert(self, pairs: list[tuple[FastqRead, FastqRead]],
                        max_pairs: int = 500) -> tuple[float, float]:
        """Insert-size estimate from mate anchor distances on the panel
        (estimateInsertSize_noGraph role, processBAM.cpp:866-989): weighted
        median for the mean, (q80-q20)/2 for the spread."""
        dists = []
        for r1, r2 in pairs[:max_pairs]:
            _, a1, p1 = self._read_ll_row(r1, len(r1.seq) * np.log(0.25))
            _, a2, p2 = self._read_ll_row(r2, len(r2.seq) * np.log(0.25))
            both = (p1 >= 0) & (p2 >= 0)
            if both.any():
                d = _outer_span(p1, p2, len(r1.seq), len(r2.seq))[both]
                dists.append(float(np.median(d)))
        if not dists:
            return 300.0, 75.0
        arr = np.asarray(dists)
        mean = float(np.median(arr))
        q20, q80 = np.quantile(arr, [0.2, 0.8])
        sd = max(float((q80 - q20) / 2.0), 1.0)
        return mean, sd

    def type_diploid_paired(self, pairs: list[tuple[FastqRead, FastqRead]],
                            insert_mean: float, insert_sd: float
                            ) -> LinearALTsResult:
        """Paired-end ALT-pair model with the insert-size term
        (processCollectedAlignments, linearALTs.h:69: per-haplotype pair
        likelihood = both mates' alignment LLs + Normal(insert) LL of their
        distance on that haplotype).  Pairs whose mates do not both anchor
        on a haplotype get the 4-sigma tail penalty instead."""
        H = len(self.names)
        sd = max(float(insert_sd), 1e-6)
        norm = -0.5 * np.log(2 * np.pi) - np.log(sd)

        def logpdf(d):
            return norm - 0.5 * ((d - insert_mean) / sd) ** 2

        tail = float(logpdf(insert_mean + 4.0 * sd))
        cols = []
        anchors = []
        for r1, r2 in pairs:
            row1, a1, p1 = self._read_ll_row(r1, len(r1.seq) * np.log(0.25))
            row2, a2, p2 = self._read_ll_row(r2, len(r2.seq) * np.log(0.25))
            both = (p1 >= 0) & (p2 >= 0)
            # outer fragment span (leftmost start -> rightmost end), the
            # same metric as BAM TLEN — cli.py feeds a TLEN-derived
            # insert_mean here; a start-to-start distance would sit one
            # read length off the model for every concordant pair
            dist = _outer_span(p1, p2, len(r1.seq),
                               len(r2.seq)).astype(np.float64)
            ins = np.where(both, np.maximum(logpdf(dist), tail), tail)
            cols.append(row1 + row2 + ins)
            anchors.append(a1 if a1 is not None else a2)
        L = (np.stack(cols).T if cols
             else np.zeros((H, 0), dtype=np.float64))
        pair = pair_ll_reduction(L, backend=self.backend)
        iu = np.triu_indices(H)
        vals = pair[iu]
        best = int(np.argmax(vals))
        h1, h2 = int(iu[0][best]), int(iu[1][best])
        p = np.exp(vals - vals.max())
        p /= p.sum()
        gene_counts: dict[str, int] = {g: 0 for g in self.genes}
        for anchor in anchors:
            if anchor is None:
                continue
            hi_, pos = anchor
            pos = self._panel_pos(hi_, pos)
            for g, (lo, hi) in self.genes.items():
                if lo <= pos < hi:
                    gene_counts[g] += 1
        return LinearALTsResult(
            hap1=self.names[h1], hap2=self.names[h2],
            posterior=float(p[best]), pair_ll=pair,
            hap_names=self.names, read_gene_counts=gene_counts)

    def reads_to_genes(self, reads: list[FastqRead]) -> dict[str, list[str]]:
        """Assign each read to the gene its best alignment overlaps
        (reads2Genes equivalent)."""
        out: dict[str, list[str]] = {g: [] for g in self.genes}
        _, anchors = self.haplotype_likelihoods(reads)
        for r, anchor in zip(reads, anchors):
            if anchor is None:
                continue
            hi_, pos = anchor
            pos = self._panel_pos(hi_, pos)
            for g, (lo, hi) in self.genes.items():
                if lo <= pos < hi:
                    out[g].append(r.name)
        return out


def _outer_span(p1: np.ndarray, p2: np.ndarray, len1: int,
                len2: int) -> np.ndarray:
    """Fragment outer span per haplotype: leftmost mate start to rightmost
    mate end — the |TLEN| metric (invalid anchors produce garbage values
    that callers mask via `both`)."""
    return (np.maximum(p1 + len1, p2 + len2) - np.minimum(p1, p2))
