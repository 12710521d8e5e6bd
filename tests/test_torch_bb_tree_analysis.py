"""Slice-6 parity for bbAnalyze's deep report (analysis/bb_analyze.py):
tests/test_bb_tree_analysis.py's cases, each through both packages on the
same backbone rows, trees and annotations, with equal node summaries,
sites and report text."""

import dataclasses
import io

import numpy as np
import pytest

from mauvealigner_tpu.analysis import bb_analyze as jax_bb
from mauvealigner_tpu.analysis.tree import parse_newick as jax_parse_newick
from mauvealigner_tpu.genome.sequence import Feature as JaxFeature
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu_torch.analysis import bb_analyze
from mauvealigner_tpu_torch.analysis.tree import parse_newick
from mauvealigner_tpu_torch.genome.sequence import Feature, Genome


def _row(n, spans):
    r = np.zeros(2 * n, np.int64)
    for s, (a, b) in spans.items():
        r[2 * s], r[2 * s + 1] = a, b
    return r


def _summaries(rows, n, newick, seq_lengths=None):
    """Node summaries of both packages, as comparable tuples; the port's."""
    got = bb_analyze.tree_node_analysis(rows, n, parse_newick(newick), seq_lengths)
    ref = jax_bb.tree_node_analysis(rows, n, jax_parse_newick(newick), seq_lengths)
    assert [str(dataclasses.astuple(s)) for s in got] == [
        str(dataclasses.astuple(s)) for s in ref]
    return got, ref


def _same_sites(got, ref):
    assert len(got) == len(ref)
    for (ga, gb, gr), (ra, rb, rr) in zip(got, ref):
        assert (ga, gb) == (ra, rb) and np.array_equal(gr, rr)


def test_hop_and_unique_classification():
    n = 4
    rows = [
        _row(n, {0: (1, 100), 1: (1, 100), 2: (1, 100), 3: (1, 100)}),
        _row(n, {0: (200, 300), 1: (200, 300)}),
        _row(n, {0: (400, 500), 1: (400, 500), 2: (400, 500)}),
        _row(n, {0: (600, 700), 2: (600, 700)}),
        _row(n, {0: (800, 805), 1: (800, 805)}),
    ]
    got, ref = _summaries(rows, n, "((0:1,1:1):1,(2:1,3:1):1);")
    root = {tuple(s.leaf_seqs): s for s in got}[(0, 1, 2, 3)]
    assert (root.n_hop_one, root.n_hop_two, root.n_unique) == (1, 1, 1)
    buf, ref_buf = io.StringIO(), io.StringIO()
    bb_analyze.write_tree_analysis(got, buf)
    jax_bb.write_tree_analysis(ref, ref_buf)
    assert buf.getvalue() == ref_buf.getvalue()
    assert "hop one" in buf.getvalue() and "pan-genome" in buf.getvalue()


def test_faux_unique_segments_cover_gaps():
    rows = [_row(2, {0: (11, 40), 1: (1, 30)})]
    got = bb_analyze.add_faux_unique_segments(rows, 2, [50, 30])
    ref = jax_bb.add_faux_unique_segments(rows, 2, [50, 30])
    assert [r.tolist() for r in got] == [r.tolist() for r in ref]
    spans0 = sorted((int(r[0]), int(r[1])) for r in got[1:] if r[0] != 0)
    assert spans0 == [(1, 10), (41, 50)]


def test_trifurcating_and_unary_nodes():
    rows = [
        _row(4, {0: (1, 100), 2: (1, 100)}),
        _row(4, {0: (200, 300), 1: (200, 300), 2: (200, 300), 3: (200, 300)}),
    ]
    got, _ = _summaries(rows, 4, "(0:1,1:1,(2:1,3:1):1);")
    root = [s for s in got if s.leaf_seqs == [0, 1, 2, 3]][0]
    assert root.n_hop_one == 1 and root.n_unique == 1
    got2, _ = _summaries([_row(2, {0: (1, 100), 1: (1, 100)})], 2, "((0:1):1,1:1);")
    assert any(s.leaf_seqs == [0, 1] for s in got2)


def test_variable_segment_and_alternalog_sites():
    n = 3
    rows = [
        _row(n, {0: (1, 100), 1: (1, 100), 2: (1, 100)}),
        _row(n, {0: (200, 300), 1: (200, 300), 2: (200, 300)}),
        _row(n, {0: (120, 180)}),
        _row(n, {1: (120, 180)}),
        _row(n, {0: (320, 400), 1: (320, 400), 2: (320, 400)}),
        _row(n, {0: (500, 600), 1: (500, 600), 2: (500, 600)}),
        _row(n, {0: (430, 470), 1: (430, 470)}),
    ]
    for alt in (False, True):
        got = bb_analyze.find_variable_segments_with_flanking_bb(rows, n, alternalogs=alt)
        _same_sites(got, jax_bb.find_variable_segments_with_flanking_bb(rows, n, alternalogs=alt))
        assert len(got) == 3


def _random_backbone(rng, rearranged: bool):
    """tests/test_bb_tree_analysis.py's random backbones: n-way flanks
    (collinear, or permuted per genome) and scattered subset rows."""
    n = int(rng.integers(2, 6))
    n_flanks = int(rng.integers(2, 8))
    lengths = rng.integers(20, 120, n_flanks)
    place = np.zeros((n_flanks, n), np.int64)
    for g in range(n):
        order = np.arange(n_flanks) if (g == 0 or not rearranged) else rng.permutation(n_flanks)
        cur = 1
        for fi in order:
            cur += int(rng.integers(0, 200))
            place[fi, g] = cur
            cur += int(lengths[fi])
    rows = []
    for fi in range(n_flanks):
        row = np.zeros(2 * n, np.int64)
        row[::2], row[1::2] = place[fi], place[fi] + int(lengths[fi]) - 1
        rows.append(row)
    for _ in range(int(rng.integers(0, 16))):
        members = rng.random(n) < 0.6
        if not members.any():
            members[int(rng.integers(0, n))] = True
        a = rng.integers(1, int(place.max() + 300), n)
        b = a + int(rng.integers(1, 80))
        row = np.zeros(2 * n, np.int64)
        row[::2], row[1::2] = np.where(members, a, 0), np.where(members, b, 0)
        rows.append(row)
    return rows, n


@pytest.mark.parametrize("rearranged", [False, True])
def test_site_detection_on_random_backbones(rearranged):
    """variable_and_alternalog_sites of both packages on 20 random
    backbones each, with the default and a raised variable-size floor."""
    rng = np.random.default_rng(41 if rearranged else 37)
    for _ in range(20):
        rows, n = _random_backbone(rng, rearranged)
        for kw in ({}, {"min_bb_size": 20, "min_variable_size": 45}):
            got = bb_analyze.variable_and_alternalog_sites(rows, n, **kw)
            ref = jax_bb.variable_and_alternalog_sites(rows, n, **kw)
            for g_list, r_list in zip(got, ref):
                _same_sites(g_list, r_list)


def test_nested_gap_translocation_site():
    n = 3
    rows = [
        _row(n, {0: (1, 100), 1: (1, 100), 2: (1, 100)}),
        _row(n, {0: (201, 300), 1: (111, 210), 2: (1000, 1100)}),
        _row(n, {0: (401, 500), 1: (401, 500), 2: (200, 300)}),
        _row(n, {0: (601, 700), 1: (601, 700), 2: (400, 500)}),
        _row(n, {0: (110, 160), 2: (310, 360)}),
    ]
    sites, alts = bb_analyze.variable_and_alternalog_sites(rows, n)
    ref_sites, ref_alts = jax_bb.variable_and_alternalog_sites(rows, n)
    _same_sites(sites, ref_sites)
    _same_sites(alts, ref_alts)
    assert any(a == 0 and b == 1 for a, b, _ in sites)
    assert not any(a == 0 and b == 1 for a, b, _ in alts)


def _genomes(length, feats):
    """The same annotated genome in both packages: feats are (kind, start,
    end, strand, gene name or None)."""
    out = []
    for G, F in ((Genome, Feature), (JaxGenome, JaxFeature)):
        g = G.from_string("A" * length)
        g.features = [F(k, a, b, s, {"gene": nm} if nm else {}) for k, a, b, s, nm in feats]
        out.append(g)
    return out


def test_analyze_variable_segments_report():
    n = 2
    rows = [
        _row(n, {0: (1, 100), 1: (1, 100)}),
        _row(n, {0: (200, 300), 1: (200, 300)}),
        _row(n, {0: (120, 180)}),
        _row(n, {1: (120, 180)}),
        _row(n, {0: (400, 500), 1: (400, 500)}),
    ]
    g0, j0 = _genomes(600, [("CDS", 80, 210, 1, "alleleA"), ("CDS", 290, 405, 1, "soloGene"),
                            ("tRNA", 130, 150, 1, None)])
    g1, j1 = _genomes(600, [("CDS", 80, 210, -1, "alleleA")])
    buf, ref_buf = io.StringIO(), io.StringIO()
    regions, per = bb_analyze.analyze_variable_segments(
        rows, n, [g0, g1], anno_index=0, alternalogs=False, out=buf)
    ref_regions, ref_per = jax_bb.analyze_variable_segments(
        rows, n, [j0, j1], anno_index=0, alternalogs=False, out=ref_buf)
    assert buf.getvalue() == ref_buf.getvalue()
    assert str(regions) == str(ref_regions) and str(per) == str(ref_per)
    assert len(regions) == 2 and "genome 1 has 1 apparent recent pseudogenes" in buf.getvalue()


def test_tree_gene_content_distribution():
    n = 3
    rows, feats = [], []
    for i in range(12):
        a = 1 + i * 40
        rows.append(_row(n, {0: (a, a + 29), 1: (a, a + 29), 2: (a, a + 29)}))
        feats.append(("CDS", a + 2, a + 20, 1, f"met{i}"))
    for i in range(12):
        feats.append(("CDS", 2000 + i * 40, 2020 + i * 40, 1, f"oth{i}"))
    ref_genome, jax_ref_genome = _genomes(4000, feats)
    cats = {f"met{i}": "metabolism" for i in range(12)}
    cats.update({f"oth{i}": "other" for i in range(12)})
    got, ref = _summaries(rows, n, "((0:1,1:1):1,2:1);")
    buf, ref_buf = io.StringIO(), io.StringIO()
    bb_analyze.write_tree_analysis(got, buf, reference=ref_genome, ref_index=0, categories=cats)
    jax_bb.write_tree_analysis(ref, ref_buf, reference=jax_ref_genome, ref_index=0,
                               categories=cats)
    assert buf.getvalue() == ref_buf.getvalue()
    assert "Avg percent conserved 50" in buf.getvalue()
