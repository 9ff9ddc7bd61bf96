"""End-to-end HLA typing on simulated data with known truth — the
TestHLATyping analogue (simulate individual -> type -> compare,
HLA-LA.cpp:1262-1340)."""

import os

import numpy as np
import pytest

from hla_la_tpu.models.pipeline import run_hla_typing
from hla_la_tpu.models.typer import HLATyper, _canonical, _chi2_p1
from hla_la_tpu.ops.pair_ll import (cluster_onehot, cluster_read_ll,
                                    pair_ll_reduction, pair_ll_reduction_numpy)
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator
from hla_la_tpu.utils.phred import log_avg


@pytest.fixture(scope="module")
def typed_world(tmp_path_factory):
    rng = np.random.default_rng(4242)
    sim = simulate_prg_package(rng, backbone_length=2400, n_haplotypes=5,
                               snp_rate=0.012)
    out_root = tmp_path_factory.mktemp("typing")
    pkg = sim.write_package(str(out_root / "pkg"))
    # diploid individual: haplotypes 1 and 2 (allele names *02:01 and *03:01)
    h1, h2 = 1, 2
    rs = ReadSimulator(rng, read_length=100, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    for h in (h1, h2):
        seq, levels = sim.linearized(h)
        pairs += [p for p in rs.simulate_pairs_from_string(
            seq, levels, haploid_coverage=18.0, name_prefix=f"hap{h}")]
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    out_dir = str(out_root / "out")
    res = run_hla_typing(pkg, pairs=fq, output_dir=out_dir)
    return sim, pkg, res, out_dir, (h1, h2)


def test_typing_recovers_truth(typed_world):
    sim, pkg, res, out_dir, (h1, h2) = typed_world
    assert res.results, "no loci typed"
    truth = {f"{h1 + 1:02d}", f"{h2 + 1:02d}"}
    for r in res.results:
        called = set()
        for allele_id in (r.allele1_id, r.allele2_id):
            for a in allele_id.split(";"):
                called.add(a.split("*")[1].split(":")[0])
        assert called == truth, (r.locus, called, truth)
        assert r.q1_allele1 > 0.5
        assert r.q1_allele2 > 0.5


def test_output_files_exist(typed_world):
    sim, pkg, res, out_dir, _ = typed_world
    hla_dir = os.path.join(out_dir, "hla")
    for fn in ["R1_bestguess.txt", "summaryStatistics.txt",
               "histogram_matchesPerRead.txt", "R1_parameters.txt"]:
        assert os.path.exists(os.path.join(hla_dir, fn)), fn
    assert os.path.exists(os.path.join(out_dir, "reads_per_level.txt"))
    for locus in ("A", "B"):
        for fn in [f"R1_PP_{locus}_pairs.txt",
                   f"R1_columnIncompatibilities_{locus}.txt",
                   f"R1_pileup_{locus}.txt", f"R1_readIDs_{locus}.txt"]:
            assert os.path.exists(os.path.join(hla_dir, fn)), fn
    with open(os.path.join(hla_dir, "R1_bestguess.txt")) as fh:
        lines = fh.read().splitlines()
    assert lines[0].startswith("Locus\tChromosome\tAllele\tQ1\tQ2")
    assert len(lines) == 1 + 2 * len(res.results)


def test_coverage_columns_sane(typed_world):
    sim, pkg, res, out_dir, _ = typed_world
    for r in res.results:
        assert r.avg_coverage > 10      # 2x18 coverage simulated
        assert r.min_coverage >= 0
        assert r.first_decile_coverage >= r.min_coverage
        assert 0 <= r.avg_column_error < 0.2
        assert r.prop_kmers_covered_1 > 0.8


def test_pair_reduction_matches_scalar():
    rng = np.random.default_rng(3)
    C, R = 7, 23
    L = rng.normal(-30, 5, (C, R))
    got = pair_ll_reduction_numpy(L, chunk=8)
    want = np.zeros((C, C))
    for a in range(C):
        for b in range(C):
            want[a, b] = sum(log_avg(L[a, r], L[b, r]) for r in range(R))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_pair_reduction_jax_matches_numpy():
    rng = np.random.default_rng(4)
    C, R = 9, 37
    L = rng.normal(-30, 5, (C, R))
    got_np = pair_ll_reduction_numpy(L)
    got_jx = pair_ll_reduction(L, backend="jax", chunk=16)
    np.testing.assert_allclose(got_np, got_jx, rtol=1e-4, atol=1e-3)


def test_cluster_ll_matmul_matches_loop():
    # scalar check of the matmul lowering on a toy example
    clusters = ["ACG_", "ACGT", "TCG*"]
    onehot = cluster_onehot(clusters)
    R, J = 2, 4
    contrib = np.zeros((R, J, 6), dtype=np.float32)
    mism = np.zeros((R, J, 6), dtype=np.float32)
    contrib[0, 0, 0] = -1.0   # read 0, col 0, channel A
    contrib[0, 0, 5] = -7.0   # channel other
    contrib[1, 3, 4] = -2.0   # read 1, col 3, channel gap
    mism[0, 0, 5] = 1.0
    ll, mm = cluster_read_ll(onehot, contrib, mism)
    assert ll.shape == (3, 2)
    assert ll[0, 0] == -1.0      # cluster 0 has A at col 0 -> channel A
    assert ll[2, 0] == 0.0       # cluster 2 has T at col 0 -> channel T (no
                                 # contribution recorded there)
    assert ll[0, 1] == -2.0      # cluster 0 has '_' at col 3 -> channel gap
    assert ll[1, 1] == 0.0       # cluster 1 has T at col 3
    # mism was recorded on channel 'other' at col 0; no cluster has a
    # non-ACGT_ char at col 0, so nothing picks it up
    assert mm.sum() == 0.0


def test_chi2_and_canonical():
    assert _canonical("ACGT") in ("ACGT",)   # palindrome
    assert _canonical("AAAA") == "AAAA"      # vs TTTT
    assert _canonical("TTTT") == "AAAA"
    p = _chi2_p1([90, 10], [95, 5])
    assert 0 < p < 1


def test_filter_first20_tied_weights_keep_both_alleles():
    """filterFirst20 with >= N observations ALL at the same weight (clean
    reads, weightedOK == 1.0) must not erase a true allele just because
    one haplotype's reads come first in input order: every observation
    tying the N-th weight counts as top-N (the reference's std::sort tie
    order is unspecified, HLATyper.cpp:1560-1565; a stable insertion-order
    top-N produced confident false-homozygous calls — caught by the
    randomized CLI soak, seeds 2001/2025/2052)."""
    from hla_la_tpu.models.typer import ExonObs, HLATyper, _ObsSoA
    from hla_la_tpu.utils.config import TyperConfig

    def obs(read_i, genotype, pos):
        return ExonObs(graph_level=pos, position_in_exon=pos,
                       genotype=genotype, qualities=b"I", mapq=1.0,
                       mapq_position=1.0, read_id=f"r{read_i}",
                       paired_read_id=f"r{read_i}", this_weighted_ok=1.0,
                       paired_weighted_ok=1.0, pairs_strands_distance=10.0,
                       alignment_cols_nongap=50, running_novel_gap=0,
                       reverse=bool(read_i % 2), from_first_read=True)

    # 25 reads of allele 'G' first, then 15 of allele 'T', all weight 1.0,
    # one shared position: both genotypes must survive
    reads_obs = ([[obs(i, "G", 7)] for i in range(25)]
                 + [[obs(25 + i, "T", 7)] for i in range(15)])
    cfg = TyperConfig()
    ign_ids: set = set()
    ign_alleles: dict = {}
    HLATyper._filter_first20(None, reads_obs, ign_ids, ign_alleles, cfg,
                             soa=_ObsSoA(reads_obs))
    assert ign_alleles.get(7, set()) == set(), ign_alleles
    assert not ign_ids
    # distinct weights: the reference semantics are unchanged — an allele
    # only in the low-weight tail IS kicked
    low = [[ExonObs(graph_level=7, position_in_exon=7, genotype="C",
                    qualities=b"I", mapq=1.0, mapq_position=1.0,
                    read_id=f"w{i}", paired_read_id=f"w{i}",
                    this_weighted_ok=0.5, paired_weighted_ok=0.5,
                    pairs_strands_distance=10.0, alignment_cols_nongap=50,
                    running_novel_gap=0, reverse=False,
                    from_first_read=True)] for i in range(3)]
    reads_obs2 = ([[obs(i, "G", 7)] for i in range(25)] + low)
    ign_ids2: set = set()
    ign_alleles2: dict = {}
    HLATyper._filter_first20(None, reads_obs2, ign_ids2, ign_alleles2, cfg,
                             soa=_ObsSoA(reads_obs2))
    assert ign_alleles2.get(7) == {"C"}, ign_alleles2


def test_filter_first20_erasure_warning_count():
    """When the filter erases an allele carrying a large share of a
    position's observations (novel-allele signature: every carrier read
    uniformly down-weighted by its own novel mismatches), the return value
    counts the affected positions so the typing log can warn (outputs are
    unchanged; found by the heldout soak, seeds 33696/33706)."""
    from hla_la_tpu.models.typer import ExonObs, HLATyper, _ObsSoA
    from hla_la_tpu.utils.config import TyperConfig

    def obs(read_i, genotype, pos, w):
        return ExonObs(graph_level=pos, position_in_exon=pos,
                       genotype=genotype, qualities=b"I", mapq=1.0,
                       mapq_position=1.0, read_id=f"r{read_i}",
                       paired_read_id=f"r{read_i}", this_weighted_ok=w,
                       paired_weighted_ok=w, pairs_strands_distance=10.0,
                       alignment_cols_nongap=50, running_novel_gap=0,
                       reverse=bool(read_i % 2), from_first_read=True)

    cfg = TyperConfig()
    # 20 pristine 'T' obs at weight 1.0 monopolise the top-20; 8 'A' obs at
    # 0.99 (8/28 = 29% >= 25%) are erased -> one warned position
    reads_obs = ([[obs(i, "T", 3, 1.0)] for i in range(20)]
                 + [[obs(20 + i, "A", 3, 0.99)] for i in range(8)])
    n = HLATyper._filter_first20(None, reads_obs, set(), {}, cfg,
                                 soa=_ObsSoA(reads_obs))
    assert n == 1
    # a thin tail (2/22 = 9% < 25%) is kicked but NOT warned about
    reads_obs2 = ([[obs(i, "T", 3, 1.0)] for i in range(20)]
                  + [[obs(20 + i, "A", 3, 0.99)] for i in range(2)])
    n2 = HLATyper._filter_first20(None, reads_obs2, set(), {}, cfg,
                                  soa=_ObsSoA(reads_obs2))
    assert n2 == 0


def test_async_output_errors_fail_loud(typed_world, tmp_path, monkeypatch):
    """A failure inside a deferred output write (pileup / PP dump built on
    the background thread) must surface as an exception from type_all,
    never a silent missing/truncated file."""
    sim, pkg, res, out_dir, _ = typed_world
    from hla_la_tpu.io.fastq import FastqRead
    from hla_la_tpu.models.typer import HLATyper

    def boom(*a, **k):
        raise RuntimeError("pileup build failed")

    monkeypatch.setattr(HLATyper, "_build_pileup", boom)
    typer = HLATyper(pkg)
    rs = ReadSimulator(np.random.default_rng(5), read_length=100,
                       fragment_mean=320, fragment_sd=30)
    seq, levels = sim.linearized(1)
    pairs = rs.simulate_pairs_from_string(seq, levels, 6.0, name_prefix="x")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    from hla_la_tpu.models.pipeline import run_hla_typing
    with pytest.raises(RuntimeError, match="pileup build failed"):
        run_hla_typing(pkg, pairs=fq, output_dir=str(tmp_path / "o"))


def test_async_flush_never_masks_primary_error(typed_world, tmp_path,
                                               monkeypatch):
    """If _type_locus raises while a deferred background write has ALSO
    failed, the primary exception must propagate — the finally-block
    flush logs the write error instead of replacing the original
    failure (ADVICE r3)."""
    sim, pkg, res, out_dir, _ = typed_world
    from hla_la_tpu.models.typer import HLATyper

    def boom_pileup(*a, **k):
        raise RuntimeError("pileup build failed")

    calls = {"n": 0}
    orig = HLATyper._type_locus

    def boom_locus(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            # first locus runs (submitting the doomed pileup write) ...
            return orig(self, *a, **k)
        raise ValueError("primary typing failure")   # ... second raises

    monkeypatch.setattr(HLATyper, "_build_pileup", boom_pileup)
    monkeypatch.setattr(HLATyper, "_type_locus", boom_locus)
    rs = ReadSimulator(np.random.default_rng(5), read_length=100,
                       fragment_mean=320, fragment_sd=30)
    seq, levels = sim.linearized(1)
    pairs = rs.simulate_pairs_from_string(seq, levels, 6.0, name_prefix="x")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    from hla_la_tpu.models.pipeline import run_hla_typing
    with pytest.raises(ValueError, match="primary typing failure"):
        run_hla_typing(pkg, pairs=fq, output_dir=str(tmp_path / "o"))
