"""Unit parity of the port's tools/manipulate.py, tools/backbone_tools.py,
tools/tree_tools.py and unique_mer_count with the JAX package's.

The same seeded numpy inputs go through both packages' functions (JAX
objects carried into the port by interop); results must be equal exactly,
since both are the same host NumPy.  The JAX package's own semantic tests
of these functions (tests/test_tools.py, tests/test_tools_extra.py,
tests/test_projection_semantics.py, tests/test_analysis_tools.py) are
mirrored on the port.
"""

import io

import numpy as np
import pytest
import torch

from mauvealigner_tpu.core.interval import Interval as JInterval
from mauvealigner_tpu.core.interval import IntervalList as JIntervalList
from mauvealigner_tpu.core.match import MatchList as JMatchList
from mauvealigner_tpu.genome.sequence import Contig as JContig
from mauvealigner_tpu.genome.sequence import Genome as JGenome
from mauvealigner_tpu.tools import backbone_tools as jbt
from mauvealigner_tpu.tools import manipulate as jman
from mauvealigner_tpu.tools import tree_tools as jtt
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis.tree import parse_newick, write_newick
from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.genome.sequence import Feature, Genome
from mauvealigner_tpu_torch.tools import backbone_tools as bt
from mauvealigner_tpu_torch.tools import manipulate as man
from mauvealigner_tpu_torch.tools import tree_tools as tt

torch.set_num_threads(1)

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _text(ivl) -> str:
    """An interval list (with its own genomes) as XMFA text."""
    buf = io.StringIO()
    ivl.write_xmfa(buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def random_ivl():
    """Three genomes of 400 bases and six intervals with random gap masks,
    strands and absent rows, tiling no genome: (JAX list, port list)."""
    rng = np.random.default_rng(7)
    seqs = [_ACGT[rng.integers(0, 4, 400)] for _ in range(3)]
    jg = [JGenome(s.copy(), name=f"g{i}") for i, s in enumerate(seqs)]
    ivs = []
    cursor = [1, 1, 1]
    for k in range(6):
        n_cols = int(rng.integers(20, 60))
        aln = rng.random((3, n_cols)) < 0.85
        starts = np.zeros(3, np.int64)
        for s in range(3):
            if k % 3 == s and k > 0:
                aln[s] = False
                continue
            aln[s, 0] = True
            m = int(aln[s].sum())
            starts[s] = cursor[s] * (-1 if rng.random() < 0.3 else 1)
            cursor[s] += m
        ivs.append(JInterval(starts, aln))
    jl = JIntervalList(genomes=jg, intervals=ivs, seq_filenames=["a", "b", "c"])
    return jl, interop.interval_list(jl)


def test_interval_tools_equal(random_ivl):
    """strip_subset_lcbs (with a sample), project_and_strip,
    alignment_projector, extract_subalignment, alignment_windows,
    strip_gap_columns, join_alignment_files and coordinate_translate give
    the same intervals (compared as XMFA text) in both packages."""
    jl, pl = random_ivl

    def over(l, ivs):
        return type(l)(genomes=l.genomes, intervals=ivs, seq_filenames=list(l.seq_filenames))

    same = [
        lambda m, l: m.strip_subset_lcbs(l, 2, 25, sample=3, seed=11),
        lambda m, l: m.project_and_strip(l, [2, 0], 2, 10),
        lambda m, l: m.alignment_projector(l, [1, 2]),
        lambda m, l: over(l, m.extract_subalignment(l, 1, 30, 90)),
        lambda m, l: over(l, m.extract_subalignment(l, 0, 5, 200)),
        lambda m, l: over(l, m.alignment_windows(l, 17, 9)),
        lambda m, l: m.strip_gap_columns(l),
        lambda m, l: m.join_alignment_files([l, l]),
    ]
    for fn in same:
        ref, got = fn(jman, jl), fn(man, pl)
        assert len(ref.intervals) > 0 and _text(ref) == _text(got)
    for s in range(3):
        for pos in (1, 17, 55, 120, 399):
            assert man.coordinate_translate(pl, s, pos) == jman.coordinate_translate(jl, s, pos)


def test_strip_subset_lcbs_bbcols_equal(random_ivl):
    """The reference mode over backbone-column segments, with the kb
    sampler's quirky draw loop, keeps the same crops in both packages."""
    from mauvealigner_tpu.analysis import backbone as jbb
    from mauvealigner_tpu_torch.analysis import backbone as pbb

    jl, pl = random_ivl
    rng = np.random.default_rng(3)
    lines = []
    for k, iv in enumerate(jl.intervals):
        a = int(rng.integers(0, iv.n_cols // 2))
        b = int(rng.integers(a + 5, iv.n_cols))
        members = [s for s in range(3) if iv.starts[s] != 0]
        lines.append("\t".join(map(str, [k, a, b - a, *members])))
    text = "\n".join(lines) + "\n"
    segs_j = jbb.read_backbone_cols_file(io.StringIO(text))
    segs_p = pbb.read_backbone_cols_file(io.StringIO(text))
    for kw in ({}, {"min_genomes": 2, "min_block_length": 3}, {"min_genomes": 2, "sample_kb": 1}):
        ref = jman.strip_subset_lcbs_bbcols(jl, segs_j, **kw)
        got = man.strip_subset_lcbs_bbcols(pl, segs_p, **kw)
        assert _text(ref) == _text(got)


def test_transpose_coordinates_equal():
    """Matches crossing removed-region junctions split identically, on
    both strands, and every coordinate moves back to the original space."""
    rng = np.random.default_rng(5)
    n = 40
    lens = rng.integers(5, 60, n)
    starts = rng.integers(1, 900, (n, 2)) * np.where(rng.random((n, 2)) < 0.3, -1, 1)
    starts[rng.random((n, 2)) < 0.1] = 0
    regions = [np.array([[50, 20], [300, 7], [610, 40]], np.int64),
               np.array([[200, 100]], np.int64)]
    ref = jman.transpose_coordinates(JMatchList(starts.copy(), lens.copy()), regions)
    got = man.transpose_coordinates(MatchList(starts.copy(), lens.copy()), regions)
    assert len(got) > n  # some matches were split at a junction
    assert np.array_equal(ref.starts, got.starts) and np.array_equal(ref.lengths, got.lengths)


def test_transpose_coordinates_shift():
    """One 100 bp region removed before position 1 of sequence 0 moves
    every sequence-0 coordinate right by 100 and leaves sequence 1
    (tests/test_tools_extra.py's CLI check, on the port's function)."""
    rng = np.random.default_rng(9)
    starts = rng.integers(1, 500, (12, 2))
    ml = MatchList(starts.copy(), rng.integers(5, 30, 12))
    out = man.transpose_coordinates(
        ml, [np.array([[1, 100]], np.int64), np.zeros((0, 2), np.int64)])
    assert len(out) == len(ml)
    assert (np.abs(out.starts[:, 0]) - np.abs(starts[:, 0]) == 100).all()
    assert np.array_equal(out.starts[:, 1], starts[:, 1])


def test_extract_subalignment_reverse_strand():
    """Both bounds hold on a reverse-strand row, whose positions descend
    along the columns (tests/test_projection_semantics.py)."""
    g0 = Genome.from_string("ACGT" * 25)
    g1 = Genome.from_string("ACGT" * 25)
    ivl = IntervalList(genomes=[g0, g1],
                       intervals=[Interval(np.array([1, -1], np.int64), np.ones((2, 100), bool))])
    subs = man.extract_subalignment(ivl, seq=1, left=30, right=50)
    assert len(subs) == 1 and subs[0].n_cols == 21
    assert subs[0].starts[1] == -30 and subs[0].starts[0] == 100 - 50 + 1


def _draft(rng, n: int, cuts, flips, order, name="d"):
    """A genome cut at `cuts`, the pieces in `flips` reverse-complemented,
    shuffled into `order`: (JAX genome of the reference, JAX draft)."""
    from mauvealigner_tpu.genome.sequence import revcomp_ascii

    ref = JGenome(_ACGT[rng.integers(0, 4, n)], name="ref")
    edges = [0, *cuts, n]
    pieces = [ref.seq[a:b] for a, b in zip(edges[:-1], edges[1:])]
    contigs, parts, off = [], [], 0
    for i in order:
        chunk = revcomp_ascii(pieces[i]) if i in flips else pieces[i]
        contigs.append(JContig(f"{name}_c{i}", len(chunk), off))
        parts.append(chunk)
        off += len(chunk)
    return ref, JGenome(np.concatenate(parts), contigs=contigs, name=name)


def _lcb(l, r, strand_draft, strand_ref=1):
    from mauvealigner_tpu.models.lcb import LCB as JLCB

    return JLCB(np.zeros(0, np.int64), float(r - l), np.array([1, l], np.int64),
                np.array([1, r], np.int64), np.array([strand_ref, strand_draft], np.int8))


def test_contig_placements_and_sort_equal():
    """contig_placements_from_lcbs (the 15-base end trim, spans under 32
    bases, reverse LCBs walking their contig range backward, first
    placement wins) and sort_contigs (placed contigs oriented, unplaced
    appended) equal in both packages on hand-built LCBs."""
    rng = np.random.default_rng(21)
    _, jd = _draft(rng, 3000, [500, 1100, 1900, 2400], {1, 3}, [3, 0, 4, 1, 2])
    pd = interop.genome(jd)
    lcb_sets = [
        [_lcb(1, 1200, 1), _lcb(1201, 3000, -1)],
        [_lcb(495, 520, 1), _lcb(2400, 2416, -1), _lcb(1, 10, 1)],   # short spans
        [_lcb(600, 2300, -1), _lcb(100, 700, 1)],                    # overlapping
        [_lcb(1390, 1420, 1)],                                       # one contig, rest unplaced
    ]
    for lcbs in lcb_sets:
        ref = jman.contig_placements_from_lcbs(jd, lcbs, draft_seq_index=1)
        got = man.contig_placements_from_lcbs(pd, interop.lcbs(lcbs), draft_seq_index=1)
        assert ref == got and len(got) > 0
        jg, jlog = jman.sort_contigs(jd, ref)
        pg, plog = man.sort_contigs(pd, got)
        assert jlog == plog and np.array_equal(jg.seq, pg.seq)
        assert [(c.name, c.length, c.offset) for c in jg.contigs] == \
            [(c.name, c.length, c.offset) for c in pg.contigs]


def test_sort_contigs_recovers_reference():
    """Three contigs, shuffled and one inverted, sorted by the port's
    anchor search on the CPU give back the reference
    (tests/test_tools.py::test_sort_contigs_cli, on the port)."""
    from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
    from mauvealigner_tpu_torch.utils import simulate

    rng = np.random.default_rng(37)
    ref = simulate.random_genome(rng, 1500)
    from mauvealigner_tpu_torch.genome.sequence import Contig, revcomp_ascii

    c1, c2, c3 = ref.seq[:500], ref.seq[500:1000], ref.seq[1000:]
    draft = Genome(np.concatenate([c3, revcomp_ascii(c2), c1]),
                   contigs=[Contig("c3", 500, 0), Contig("c2rc", 500, 500),
                            Contig("c1", 500, 1000)])
    al = MauveAligner(AlignerOptions(seed_size=11, gapped=False, recursive=False,
                                     use_sml_cache=False, device="cpu"))
    _, lcbs = al.determine_lcbs([ref, draft], al.find_mums([ref, draft]))
    fixed, log = man.sort_contigs(draft, man.contig_placements_from_lcbs(draft, lcbs, 1))
    assert [c.name for c in fixed.contigs] == ["c1", "c2rc", "c3"]
    assert log == [("c1", 1), ("c2rc", -1), ("c3", 1)]
    assert fixed.to_string() == ref.to_string()


def test_unalign_sequences_equal(random_ivl):
    jl, pl = random_ivl
    a, b = io.StringIO(), io.StringIO()
    jman.unalign_sequences(jl, a)
    man.unalign_sequences(pl, b)
    assert a.getvalue() == b.getvalue() and a.getvalue().count(">") == 3


def test_bb_filter_mean_length_and_informative_only():
    """ShorterThan drops rows whose integer-mean member length is below
    the threshold; feature matrices drop constant patterns; unique
    segments fill each genome's holes (tests/test_analysis_tools.py, on
    the port)."""
    rows = [np.array([1, 40, 1, 40], np.int64), np.array([41, 65, 0, 0], np.int64),
            np.array([66, 75, 41, 65], np.int64), np.array([0, 0, 66, 70], np.int64)]
    kept = bt.bb_filter(rows, min_length=20)
    assert len(kept) == 2
    assert bt.presence_absence_matrix(kept, 2, informative_only=True).tolist() == [[1, 0]]
    aug = bt.add_unique_segments_rows([np.array([1, 30, 1, 30], np.int64),
                                       np.array([51, 80, 31, 60], np.int64)])
    assert [31, 50, 0, 0] in [r.tolist() for r in aug[2:]]


@pytest.fixture(scope="module")
def bb_rows():
    """Random backbone rows over three 600-base genomes (one of two
    contigs each), signed, with absent members."""
    rng = np.random.default_rng(13)
    rows = []
    for _ in range(25):
        r = np.zeros(6, np.int64)
        for s in range(3):
            if rng.random() < 0.2:
                continue
            left = int(rng.integers(1, 560))
            right = left + int(rng.integers(0, 40))
            sign = -1 if rng.random() < 0.3 else 1
            r[2 * s], r[2 * s + 1] = sign * left, sign * right
        rows.append(r)
    seqs = [_ACGT[rng.integers(0, 4, 600)] for _ in range(3)]
    jg = [JGenome(s.copy(), contigs=[JContig(f"g{i}a", 250, 0), JContig(f"g{i}b", 350, 250)],
                  name=f"g{i}") for i, s in enumerate(seqs)]
    return rows, jg, interop.genomes(jg)


def test_backbone_row_tools_equal(bb_rows):
    rows, jg, pg = bb_rows
    for ml in (0, 10, 25):
        for ind in (0, 30):
            ref = jbt.bb_filter(rows, ml, ind)
            got = bt.bb_filter(rows, ml, ind)
            assert [r.tolist() for r in ref] == [r.tolist() for r in got]
    for info in (False, True):
        assert np.array_equal(jbt.presence_absence_matrix(rows, 3, info),
                              bt.presence_absence_matrix(rows, 3, info))
    assert [r.tolist() for r in jbt.add_unique_segments_rows(rows)] == \
        [r.tolist() for r in bt.add_unique_segments_rows(rows)]
    m = bt.presence_absence_matrix(rows, 3, True)
    for writer in ("write_beast_xml", "write_genoplast"):
        a, b = io.StringIO(), io.StringIO()
        getattr(jbt, writer)(m, ["x", "y", "z"], a)
        getattr(bt, writer)(m, ["x", "y", "z"], b)
        assert a.getvalue() == b.getvalue()
    assert jbt.backbone_global_to_local(rows, jg) == bt.backbone_global_to_local(rows, pg)
    assert np.array_equal(jbt.backbone_coverage(rows, [600] * 3),
                          bt.backbone_coverage(rows, [600] * 3))
    assert jbt.extract_backbone_sequences(rows, jg) == bt.extract_backbone_sequences(rows, pg)
    a, b = io.StringIO(), io.StringIO()
    jbt.write_backbone_mfa(rows, jg, a)
    bt.write_backbone_mfa(rows, pg, b)
    assert a.getvalue() == b.getvalue()


def test_random_gene_sample_equal():
    """The sample draws from numpy's generator with the same seed in both
    packages: the same genes, in the same order."""
    orthos = [{"id": i, "name": f"gene{i}"} for i in range(30)]
    for seed, count in ((37, 5), (1, 12), (2, 40)):
        assert jbt.random_gene_sample(orthos, count, seed) == bt.random_gene_sample(
            orthos, count, seed)


def test_ortholog_and_pair_compare_equal(random_ivl, tmp_path):
    """ortholog_list, random_gene_alignments and pair_compare on an
    alignment whose genomes carry CDS features: equal results and equal
    per-gene files."""
    from mauvealigner_tpu.genome.sequence import Feature as JFeature

    jl, _ = random_ivl
    spans = [(5, 40, 1), (60, 120, -1), (130, 170, 1), (200, 260, 1)]
    for s, g in enumerate(jl.genomes):
        g.features = [JFeature("CDS", a + s, b + s, st, {"gene": f"f{k}"})
                      for k, (a, b, st) in enumerate(spans)]
    pl = interop.interval_list(jl)
    for s, g in enumerate(pl.genomes):
        g.features = [Feature("CDS", a + s, b + s, st, {"gene": f"f{k}"})
                      for k, (a, b, st) in enumerate(spans)]
    rows = [np.array([1, 150, 1, 150, 2, 151], np.int64),
            np.array([151, 300, 152, 290, 153, 280], np.int64)]
    ref = jbt.ortholog_list(jl, rows, 0, str(tmp_path / "j"))
    got = bt.ortholog_list(pl, rows, 0, str(tmp_path / "t"))
    assert ref == got and len(got) > 0
    ref = jbt.random_gene_alignments(jl, rows, 1, 2, str(tmp_path / "jg"), seed=4)
    got = bt.random_gene_alignments(pl, rows, 1, 2, str(tmp_path / "tg"), seed=4)
    assert [{**o, "file": o["file"][-6:]} for o in ref] == \
        [{**o, "file": o["file"][-6:]} for o in got]
    for o in ref:
        tail = o["file"].rsplit("_", 1)[1]
        assert (tmp_path / f"jg_{tail}").read_bytes() == (tmp_path / f"tg_{tail}").read_bytes()
    assert jbt.pair_compare(jl, jl.genomes, rows) == bt.pair_compare(pl, pl.genomes, rows)
    pair_j = jman.alignment_projector(jl, [0, 1])
    pair_p = man.alignment_projector(pl, [0, 1])
    assert jbt.pair_compare(pair_j, pair_j.genomes) == bt.pair_compare(pair_p, pair_p.genomes)


TRPROBS = """#NEXUS
begin trees;
   translate
      1 taxA,
      2 taxB,
      3 taxC,
      4 taxD;
   tree tree_1 [p = 0.40] [P = 0.40] = [&W 0.40] ((1,2),(3,4));
   tree tree_2 [p = 0.35] [P = 0.75] = [&W 0.35] ((2,1),(4,3));
   tree tree_3 [p = 0.10] [P = 0.85] = [&W 0.10] ((1,3),(2,4));
   tree tree_4 [p = 0.08] [P = 0.93] = [&W 0.08] ((1,4),(2,3));
end;
"""


def test_extract_bci_aggregation():
    """Identical topologies across files sum their posteriors, the BCI
    cutoff stops reading, and an over-budget set subsamples by weight
    (tests/test_tools.py, on the port); equal to the JAX package for
    several seeds."""
    uniq = tt.aggregate_bci_trees([TRPROBS, TRPROBS], 0.9)
    assert [round(w, 6) for _, w in uniq] == [1.5, 0.2, 0.16]
    assert tt.topology_key(uniq[0][0]) == "((taxA,taxB),(taxC,taxD))"
    for seed in (1, 2, 3, 37):
        for cred, budget in ((0.9, 2), (0.5, 1), (0.99, 0)):
            ref = jtt.aggregate_bci_trees([TRPROBS, TRPROBS], cred, budget, seed)
            got = tt.aggregate_bci_trees([TRPROBS, TRPROBS], cred, budget, seed)
            from mauvealigner_tpu.analysis.tree import write_newick as jwrite

            assert [(jwrite(t), w) for t, w in ref] == [(write_newick(t), w) for t, w in got]


def test_tree_tools_equal():
    """uniquify_trees, root_trees, parse_nexus_trees and check_for_lgt
    (its unrooted complement case included, tests/test_projection_semantics.py)
    equal in both packages."""
    from mauvealigner_tpu.analysis.tree import parse_newick as jparse
    from mauvealigner_tpu.analysis.tree import write_newick as jwrite

    texts = ["((a:1,b:1):1,(c:1,d:1):1);", "((b:1,a:1):1,(c:1,d:1):1);",
             "((a:1,c:1):1,(b:1,d:1):1);", "(a,(b,(c,d)));", "(a,(c,(b,d)));",
             "((a,(e,b)),(c,d));"]
    jt, pt = [jparse(t) for t in texts], [parse_newick(t) for t in texts]
    uniq = tt.uniquify_trees(pt)
    assert [jwrite(t) for t in jtt.uniquify_trees(jt)] == [write_newick(t) for t in uniq]
    assert len(tt.uniquify_trees(pt[:3])) == 2
    for og in ({"c", "d"}, {"a"}, {"b", "d"}):
        assert [jwrite(t) for t in jtt.root_trees(jt, og)] == \
            [write_newick(t) for t in tt.root_trees(pt, og)]
    for ga, gb in (({"a", "b"}, {"c", "d"}), ({"a", "e"}, {"c"}), ({"x"}, {"c"})):
        assert [jtt.check_for_lgt(t, ga, gb) for t in jt] == \
            [tt.check_for_lgt(t, ga, gb) for t in pt]
    assert tt.check_for_lgt(parse_newick("(a,(b,(c,d)));"), {"a", "b"}, {"c", "d"}) is False
    assert tt.check_for_lgt(parse_newick("(a,(c,(b,d)));"), {"a", "b"}, {"c", "d"}) is True
    (jtrees, jtr), (ptrees, ptr) = jtt.parse_nexus_trees(TRPROBS), tt.parse_nexus_trees(TRPROBS)
    assert jtr == ptr and [(n, jwrite(t)) for n, t in jtrees] == \
        [(n, write_newick(t)) for n, t in ptrees]


def test_unique_mer_count_equal():
    """merops.unique_mer_count on sorted random keys (runs of one to four
    copies, both strand bits), and SortedMerList.unique_mer_count of a
    genome with planted repeats built by each package (the port's K1 on
    the CPU)."""
    from mauvealigner_tpu.core.sml import build_sml as jbuild
    from mauvealigner_tpu.ops import merops as jmerops
    from mauvealigner_tpu.seeds import get_seed as jget_seed
    from mauvealigner_tpu_torch.core.sml import build_sml
    from mauvealigner_tpu_torch.ops import merops
    from mauvealigner_tpu_torch.seeds import get_seed

    rng = np.random.default_rng(17)
    mers = rng.integers(0, 5000, 3000)
    keys = np.sort(np.concatenate([mers, mers[:700], mers[:150]]) * 2 + rng.integers(0, 2, 3850))
    for n_valid in (0, 1, 2000, len(keys)):
        assert merops.unique_mer_count(keys, n_valid) == jmerops.unique_mer_count(keys, n_valid)
    unit = _ACGT[rng.integers(0, 4, 300)]
    seq = np.concatenate([_ACGT[rng.integers(0, 4, 2000)], unit, _ACGT[rng.integers(0, 4, 900)],
                          unit, _ACGT[rng.integers(0, 4, 500)]])
    for w in (9, 13):
        ref = jbuild(JGenome(seq.copy()), jget_seed(w, 0)).unique_mer_count()
        got = build_sml(Genome(seq.copy()), get_seed(w, 0), "cpu").unique_mer_count()
        assert got == ref and 0 < got < len(seq)
