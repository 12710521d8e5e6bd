"""Slice-6 parity for the analysis modules and their subcommands:
analysis/islands.py (tests/test_analysis.py's island, backbone and coverage
cases), analysis/evd.py with evd and multiEVD, scoreAlignment with the
reference counters, and analysis/bb_analyze.py with bbAnalyze and
bbBreakOnGenes (tests/test_analysis_tools.py).  Each case runs both
packages on the same input and requires equal results: the modules are the
same host NumPy, so islands, segments, counters, reports and files are
equal byte for byte, and the EVD floats exactly (the same numpy draws and
the same float64 arithmetic in the same order)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from mauvealigner_tpu.analysis import evd as jax_evd
from mauvealigner_tpu.analysis import islands as jax_islands
from mauvealigner_tpu.analysis import score_alignment as jax_score
from mauvealigner_tpu.analysis.bb_analyze import bb_analyze_report as jax_bb_report
from mauvealigner_tpu.core.interval import Interval as JaxInterval
from mauvealigner_tpu.core.interval import IntervalList as JaxIntervalList
from mauvealigner_tpu.genome.sequence import Feature as JaxFeature
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu.utils import simulate as jax_simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis import evd, islands, score_alignment
from mauvealigner_tpu_torch.analysis.bb_analyze import bb_analyze_report
from mauvealigner_tpu_torch.genome.sequence import Feature
from mauvealigner_tpu_torch.tools.cli import main as torch_cli

torch.set_num_threads(1)


def _both_clis(tmp_path, argv, outputs=()):
    """Both CLIs in tmp_path ("{o}" in argv -> j / t); identical standard
    output and output files.  Returns the port's standard output."""
    outs = {}
    with contextlib.chdir(tmp_path):
        for tag, cli in (("j", jax_cli), ("t", torch_cli)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli([a.replace("{o}", tag) for a in argv]) == 0
            outs[tag] = buf.getvalue()
    assert outs["j"] == outs["t"]
    for name in outputs:
        ref = (tmp_path / name.replace("{o}", "j")).read_bytes()
        got = (tmp_path / name.replace("{o}", "t")).read_bytes()
        assert len(ref) > 0 and ref == got, name
    return outs["t"]


# ---------------- islands / backbone (tests/test_analysis.py) ----------------

def _iv_with_gap_island(gap_len=30):
    g0 = JaxGenome.from_string("A" * 200)
    g1 = JaxGenome.from_string("A" * (200 - gap_len))
    aln1 = np.ones(200, bool)
    aln1[100 : 100 + gap_len] = False
    iv = JaxInterval(np.array([1, 1], np.int64), np.stack([np.ones(200, bool), aln1]))
    ivl = JaxIntervalList(genomes=[g0, g1], intervals=[iv])
    return ivl, interop.interval_list(ivl)


def test_simple_find_islands():
    ref_ivl, ivl = _iv_with_gap_island(30)
    got = islands.simple_find_islands(ivl, island_size=20)
    ref = jax_islands.simple_find_islands(ref_ivl, island_size=20)
    assert [dataclasses.astuple(i) for i in got] == [dataclasses.astuple(i) for i in ref]
    assert len(got) == 1 and got[0].seq_i == 1 and got[0].seq_j == 0
    assert got[0].right_j - got[0].left_j == 29


def test_simple_find_backbone_splits_on_big_gap():
    ref_ivl, ivl = _iv_with_gap_island(30)
    got = islands.simple_find_backbone(ivl, min_bb_length=10, max_gap_length=10)
    ref = jax_islands.simple_find_backbone(ref_ivl, min_bb_length=10, max_gap_length=10)
    assert len(got) == 2
    assert [str(dataclasses.astuple(s)) for s in got] == [
        str(dataclasses.astuple(s)) for s in ref]
    buf, ref_buf = io.StringIO(), io.StringIO()
    islands.write_backbone(got, buf, 2)
    jax_islands.write_backbone(ref, ref_buf, 2)
    assert buf.getvalue() == ref_buf.getvalue()


def test_coverage_fraction():
    ref_ivl, ivl = _iv_with_gap_island(30)
    got = islands.coverage_fraction(ivl, [200, 170])
    assert np.array_equal(got, jax_islands.coverage_fraction(ref_ivl, [200, 170]))
    assert got[0] == 1.0 and got[1] == 1.0


def test_islands_between_lcbs():
    """Unaligned stretches between and around LCBs, per genome."""
    g0 = JaxGenome.from_string("A" * 400)
    g1 = JaxGenome.from_string("A" * 380)
    ivs = [JaxInterval(np.array([61, 1], np.int64), np.ones((2, 100), bool)),
           JaxInterval(np.array([251, -201], np.int64), np.ones((2, 90), bool))]
    ref_ivl = JaxIntervalList(genomes=[g0, g1], intervals=ivs)
    got = islands.find_islands_between_lcbs(interop.interval_list(ref_ivl), [400, 380], 40)
    assert got == jax_islands.find_islands_between_lcbs(ref_ivl, [400, 380], 40)
    assert len(got) >= 3


# ---------------- EVD (tests/test_analysis_tools.py) ----------------

def test_score_excursions():
    scores = np.array([5, 5, -20, 3, 3, 3, -1, -20, 2])
    got = evd.score_excursions(scores)
    assert list(got) == [10.0, 9.0, 2.0]
    assert np.array_equal(got, jax_evd.score_excursions(scores))


@pytest.mark.parametrize("seed", [1, 37])
def test_simulate_evd_exact(seed):
    got = evd.simulate_evd(seq_length=3000, n_trials=5, seed=seed, gc_content=0.4)
    ref = jax_evd.simulate_evd(seq_length=3000, n_trials=5, seed=seed, gc_content=0.4)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.n_excursions > 10 and got.gumbel_lambda > 0
    assert evd.significance_threshold(got, 0.01) == jax_evd.significance_threshold(ref, 0.01)


def test_merge_evd():
    parts = [evd.simulate_evd(seq_length=2000, n_trials=3, seed=s) for s in (1, 2)]
    ref_parts = [jax_evd.simulate_evd(seq_length=2000, n_trials=3, seed=s) for s in (1, 2)]
    got = evd.merge_evd_results(parts)
    assert got.n_excursions == parts[0].n_excursions + parts[1].n_excursions
    assert dataclasses.astuple(got) == dataclasses.astuple(jax_evd.merge_evd_results(ref_parts))


def test_evd_and_multi_evd_cli(tmp_path):
    _both_clis(tmp_path, ["evd", "--length=2000", "--trials=3", "--gc=0.45",
                          "--output={o}.e1.txt"], ["{o}.e1.txt"])
    _both_clis(tmp_path, ["evd", "--length=1500", "--trials=2", "--output={o}.e2.txt"],
               ["{o}.e2.txt"])
    out = _both_clis(tmp_path, ["multiEVD", "j.e1.txt", "j.e2.txt"])
    assert "lambda" in out


def test_evd_alignjob_mode(tmp_path):
    """Reference evd / multiEVD mode over alignjob.N directories."""
    rng = np.random.default_rng(37)
    for run in range(2):
        d = tmp_path / f"alignjob.{run}"
        d.mkdir()
        anc = jax_simulate.random_genome(rng, 2000, name="s0")
        seq1 = anc.seq.copy()
        seq1[800:1000] = jax_simulate.random_genome(rng, 200).seq
        g0, g1 = JaxGenome(anc.seq.copy(), name="s0"), JaxGenome(seq1, name="s1")
        iv = JaxInterval(np.array([1, 1], np.int64), np.ones((2, 2000), bool))
        JaxIntervalList(genomes=[g0, g1], intervals=[iv],
                        seq_filenames=["s0", "s1"]).write_xmfa(str(d / "evolved.dat"))
        with open(d / "evolved_seqs.fas", "w") as fh:
            for g in (g0, g1):
                fh.write(f">{g.name}\n{g.to_string()}\n")
    out = _both_clis(tmp_path, ["evd", "2", "--output=-"])
    assert "Total number of simulations: 2" in out and "95% score threshold:" in out
    assert "multiplicity 2:" in _both_clis(tmp_path, ["multiEVD", "2"])


# ---------------- scoreAlignment and the reference counters ----------------

def test_score_alignment_cli(tmp_path):
    """A pair with its simulation truth, the calculated alignment from the
    JAX progressiveMauve, scored by both subcommands (with --evolved-seqs)."""
    rng = np.random.default_rng(37)
    anc = jax_simulate.random_genome(rng, 1200)
    der, truth = jax_simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
    for name, g in (("a.fa", anc), ("b.fa", der)):
        with open(tmp_path / name, "w") as fh:
            fh.write(f">{name}\n{g.to_string()}\n")
    truth.seq_filenames = ["a.fa", "b.fa"]
    truth.write_xmfa(str(tmp_path / "truth.xmfa"))
    with contextlib.chdir(tmp_path):
        assert jax_cli(["progressiveMauve", "a.fa", "b.fa", "--seed-weight=11",
                        "--disable-cache", "--output=pm.xmfa"]) == 0
    out = _both_clis(tmp_path, ["scoreAlignment", "truth.xmfa", "pm.xmfa", "a.fa", "b.fa",
                                "--evolved-seqs=b.fa"])
    sn = float([l for l in out.splitlines() if l.startswith("Sensitivity")][0].split()[1])
    assert sn > 0.8


def _two_seq_ivl(aln0, aln1):
    g0 = JaxGenome.from_string("A" * 6, name="g0")
    g1 = JaxGenome.from_string("A" * 6, name="g1")
    iv = JaxInterval(np.array([1, 1], np.int64),
                     np.stack([np.array(aln0, bool), np.array(aln1, bool)]))
    return JaxIntervalList(genomes=[g0, g1], intervals=[iv])


@pytest.mark.parametrize("case,want", [
    ("missed_pair_is_fp", (6, 2, 0, 0)),
    ("overalignment_is_fn", (6, 0, 2, 0)),
    ("unaligned_miss_is_fn", (6, 0, 2, 0)),
    ("perfect", (6, 0, 0, 2)),
])
def test_reference_counters(case, want):
    """tests/test_analysis_tools.py's four reference-counter cases."""
    gapped = ([1, 1, 1, 1, 0], [1, 1, 1, 0, 1])
    full = ([1, 1, 1, 1], [1, 1, 1, 1])
    correct, calc = {
        "missed_pair_is_fp": (full, gapped),
        "overalignment_is_fn": (gapped, full),
        "unaligned_miss_is_fn": (full, ([1, 1, 1], [1, 1, 1])),
        "perfect": (gapped, gapped),
    }[case]
    jc, jk = _two_seq_ivl(*correct), _two_seq_ivl(*calc)
    ref = jax_score.reference_counters(jc, jk, [6, 6])
    got = score_alignment.reference_counters(
        interop.interval_list(jc), interop.interval_list(jk), [6, 6])
    assert (got.tp, got.fp, got.fn, got.tn) == want
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.summary() == ref.summary()


# ---------------- bbAnalyze and bbBreakOnGenes ----------------

def test_bb_analyze_cli(tmp_path):
    with open(tmp_path / "bb.backbone", "w") as fh:
        fh.write("seq0_leftend\tseq0_rightend\tseq1_leftend\tseq1_rightend\t"
                 "seq2_leftend\tseq2_rightend\n")
        fh.write("1\t500\t1\t480\t1\t490\n")
        fh.write("601\t900\t0\t0\t551\t850\n")
        fh.write("951\t1100\t0\t0\t0\t0\n")
        fh.write("1201\t1500\t1001\t1300\t901\t1200\n")
    with open(tmp_path / "t.nwk", "w") as fh:
        fh.write("((0:1,1:1):1,2:1);\n")
    _both_clis(tmp_path, ["bbAnalyze", "bb.backbone", "{o}.report.txt"], ["{o}.report.txt"])
    _both_clis(tmp_path, ["bbAnalyze", "bb.backbone", "{o}.tree.txt", "--guide-tree=t.nwk"],
               ["{o}.tree.txt"])
    text = (tmp_path / "t.report.txt").read_text()
    assert "core segments: 2" in text and "variable segments: 2" in text


def test_bb_analyze_alternalog_breakdown():
    """The annotated report (genic, spanner, RNA, intergenic neighbour
    orientation) from both packages on the same annotations."""
    spec = [("CDS", 100, 400, 1), ("CDS", 700, 900, -1), ("CDS", 1200, 1400, 1),
            ("tRNA", 1500, 1550, 1), ("CDS", 1700, 1900, 1)]
    rows = [np.array(r, np.int64) for r in ([150, 350, 150, 350], [380, 450, 0, 0],
                                             [500, 600, 0, 0], [950, 1100, 0, 0],
                                             [1450, 1600, 0, 0])]
    ref_genome = JaxGenome.from_string("A" * 2000, name="ref")
    ref_genome.features = [JaxFeature(*f) for f in spec]
    genome = interop.genome(ref_genome)
    genome.features = [Feature(*f) for f in spec]
    buf, ref_buf = io.StringIO(), io.StringIO()
    got = bb_analyze_report(rows, 2, genome, out=buf)
    ref = jax_bb_report(rows, 2, ref_genome, out=ref_buf)
    assert buf.getvalue() == ref_buf.getvalue()
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in ref]
    assert got[1].spanner and got[2].neighbor == "converging" and got[4].contains_trna


def test_bb_break_on_genes_cli(tmp_path):
    """GenBank mode (gene bounds from CDS features) and .ptt mode."""
    seq = "acgt" * 250
    lines = [f"{i + 1:>9} {seq[i:i + 60]}" for i in range(0, 1000, 60)]
    with open(tmp_path / "ref.gbk", "w") as fh:
        fh.write("LOCUS       TEST                  1000 bp    DNA     linear UNK\n"
                 "FEATURES             Location/Qualifiers\n"
                 "     CDS             201..400\n"
                 "                     /gene=\"g1\"\nORIGIN\n" + "\n".join(lines) + "\n//\n")
    with open(tmp_path / "g2.fa", "w") as fh:
        fh.write(">g2\n" + seq.upper() + "\n")
    g0 = JaxGenome.from_string(seq.upper(), name="ref")
    g1 = JaxGenome.from_string(seq.upper(), name="g2")
    JaxIntervalList(
        genomes=[g0, g1],
        intervals=[JaxInterval(np.array([1, 1], np.int64), np.ones((2, 1000), bool))],
        seq_filenames=["ref.gbk", "g2.fa"],
    ).write_xmfa(str(tmp_path / "a.xmfa"))
    _both_clis(tmp_path, ["bbBreakOnGenes", "a.xmfa", "20", "{o}.broken.txt"],
               ["{o}.broken.txt"])
    with open(tmp_path / "ref.ptt", "w") as fh:
        fh.write("h1\nh2\nh3\n201..400\t+\t66\tg1\n")
    with open(tmp_path / "empty.ptt", "w") as fh:
        fh.write("h1\nh2\nh3\n")
    _both_clis(tmp_path, ["bbBreakOnGenes", "a.xmfa", "20", "{o}.b2.txt", "ref.ptt",
                          "empty.ptt"], ["{o}.b2.txt"])
    rows = [l for l in (tmp_path / "t.b2.txt").read_text().splitlines()
            if l and not l.startswith("seq0")]
    assert sorted(int(r.split("\t")[0]) for r in rows) == [1, 200, 201, 400, 401]
