"""Parity of the port's projection, strip, backbone, coverage, tree and
contig subcommands with the JAX package's.

Each test runs one subcommand of both CLIs on the same files in one
directory (sortContigs and uniqueMerCount of the port with --device=cpu,
the plain-torch path), each package writing its own output names, and holds
every output file and the standard output byte for byte equal: these tools
are the same host NumPy in both packages, so nothing may differ.  The
alignments they read are written once per module by the JAX package's
progressiveMauve and mauveAligner; the inputs are simulated from numpy
seeds (utils/simulate).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu_torch.genome.sequence import Contig, Genome, revcomp_ascii
from mauvealigner_tpu_torch.tools.cli import main as torch_cli
from mauvealigner_tpu_torch.utils import simulate
from test_torch_tools import _write_fasta, run_both

torch.set_num_threads(1)

PAIR = ["a.fa", "b.fa"]
GBK = ["a.gbk", "b.gbk"]
# (start, end, strand, gene) of the annotated CDS, the same in both genomes'
# GenBank files (the descendant's coordinates shift by its indels only)
CDS = [(101, 400, 1, "orfA"), (601, 900, -1, "orfB"), (1201, 1650, 1, "orfC"),
       (2001, 2300, -1, "orfD"), (2701, 2990, 1, "orfE")]


def _write_gbk(path, seq_text: str, name: str) -> None:
    lines = [f"LOCUS       {name}{len(seq_text):>17} bp    DNA     linear   UNA",
             "FEATURES             Location/Qualifiers"]
    for a, b, strand, gene in CDS:
        loc = f"{a}..{b}" if strand > 0 else f"complement({a}..{b})"
        lines += [f"     CDS             {loc}", f'                     /gene="{gene}"']
    lines.append("ORIGIN")
    for i in range(0, len(seq_text), 60):
        chunk = seq_text[i : i + 60]
        lines.append(f"{i + 1:>9} " + " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10)))
    lines.append("//")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two 3.2 kbp genomes (1% substitutions, indels), their GenBank files
    with five CDS, a three-record FASTA of the descendant, and the JAX
    package's progressiveMauve alignment (pm.xmfa, .backbone, .bbcols),
    its interval file (pm.mln), its mauveAligner --mums match list (m.mln),
    the pairwise alignment under all_pairs/ and the tree files."""
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(41)
    anc = simulate.random_genome(rng, 3200)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
    _write_fasta(d / "a.fa", anc, "a")
    _write_fasta(d / "b.fa", der, "b")
    _write_gbk(d / "a.gbk", anc.seq.tobytes().decode().lower(), "a")
    _write_gbk(d / "b.gbk", der.seq.tobytes().decode().lower(), "b")
    text = der.seq.tobytes().decode()
    with open(d / "b3.fa", "w") as fh:
        for k, (lo, hi) in enumerate(((0, 900), (900, 2100), (2100, len(text)))):
            fh.write(f">b_c{k}\n{text[lo:hi]}\n")
    with contextlib.chdir(d):
        assert jax_cli(["progressiveMauve", *PAIR, "--seed-weight=9", "--disable-cache",
                        "--output=pm.xmfa"]) == 0
        assert jax_cli(["mauveAligner", *PAIR, "--seed-size=9", "--mums",
                        "--output=m.mln"]) == 0
        from mauvealigner_tpu.core import mln
        from mauvealigner_tpu.core.interval import IntervalList
        from mauvealigner_tpu.tools.common import load_genomes

        ivl = IntervalList.read_xmfa("pm.xmfa")
        ivl.genomes = load_genomes(PAIR)
        mln.write_interval_list(ivl, "pm.mln")
        os.makedirs("all_pairs", exist_ok=True)
        ivl.write_xmfa(os.path.join("all_pairs", "pair_0.1.xmfa"))
        with open("regions.tsv", "w") as fh:
            fh.write("0\t1\t100\n0\t1500\t40\n1\t800\t25\n")
        with open("flat.txt", "w") as fh:
            fh.write("1 100\n1500 40\n")
        with open("coords.txt", "w") as fh:
            fh.write("0 0\n0 17\n0 500\n")
        with open("trees.nwk", "w") as fh:
            fh.write("((a:1,b:1):1,(c:1,d:1):1);\n((b:1,a:1):1,(c:1,d:1):1);\n"
                     "((a:1,c:1):1,(b:1,d:1):1);\n(a,(b,(c,d)));\n(a,(c,(b,d)));\n")
        with open("t.trprobs", "w") as fh:
            fh.write(TRPROBS)
    assert (d / "pm.xmfa.backbone").exists() and (d / "pm.xmfa.bbcols").exists()
    return d


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

# subcommand case -> (argv with "{o}" for each package's output names,
# output files to compare)
CASES = {
    "transposeCoordinates": (["transposeCoordinates", "m.mln", "regions.tsv", "{o}.tc.mln"],
                             ["{o}.tc.mln"]),
    "transposeCoordinates-seq": (["transposeCoordinates", "m.mln", "flat.txt", "0",
                                  "{o}.tc2.mln"], ["{o}.tc2.mln"]),
    "stripGapColumns": (["stripGapColumns", "pm.xmfa", "{o}.sg.xmfa", *PAIR], ["{o}.sg.xmfa"]),
    "stripSubsetLCBs": (["stripSubsetLCBs", "pm.xmfa", "{o}.ss.xmfa", "--min-seqs=2",
                         "--min-length=30", "--sample=2", *PAIR], ["{o}.ss.xmfa"]),
    "stripSubsetLCBs-bbcols": (["stripSubsetLCBs", "pm.xmfa", "{o}.ssb.xmfa",
                                "--bbcols=pm.xmfa.bbcols", "--min-length=20",
                                "--sample-kb=1", *PAIR], ["{o}.ssb.xmfa"]),
    "alignmentProjector": (["alignmentProjector", "pm.xmfa", "{o}.ap.xmfa", "--seqs=1,0", *PAIR],
                           ["{o}.ap.xmfa"]),
    "projectAndStrip": (["projectAndStrip", "pm.xmfa", "{o}.ps.xmfa", "--seqs=0,1",
                         "--min-length=40", *PAIR], ["{o}.ps.xmfa"]),
    "extractSubalignments": (["extractSubalignments", "pm.xmfa", "{o}.es.xmfa", "--seq=1",
                              "--left=700", "--right=2400", *PAIR], ["{o}.es.xmfa"]),
    "getAlignmentWindows": (["getAlignmentWindows", "pm.xmfa", "{o}.win.xmfa", "--window=500",
                             "--step=300", *PAIR], ["{o}.win.xmfa"]),
    "getAlignmentWindows-dir": (["getAlignmentWindows", "pm.xmfa", "{o}_win", "--window=700",
                                 *PAIR], ["{o}_win"]),
    "joinAlignmentFiles": (["joinAlignmentFiles", "{o}.join.xmfa", "pm.xmfa", "{o}.sg.xmfa"],
                           ["{o}.join.xmfa"]),
    "addUnalignedIntervals": (["addUnalignedIntervals", "pm.xmfa", "{o}.au.xmfa", *PAIR],
                              ["{o}.au.xmfa"]),
    "coordinateTranslate": (["coordinateTranslate", "pm.xmfa", "coords.txt",
                             "--seq-files=a.fa,b.fa"], []),
    "coordinateTranslate-position": (["coordinateTranslate", "pm.xmfa", "--seq=1",
                                      "--position=1234", "--seq-files=a.fa,b.fa"], []),
    "unalign": (["unalign", "pm.xmfa", "{o}.un.mfa", *PAIR], ["{o}.un.mfa"]),
    "unalign-bbcols": (["unalign", "pm.xmfa", "{o}.unb.xmfa", "--bbcols=pm.xmfa.bbcols", *PAIR],
                       ["{o}.unb.xmfa"]),
    "bbFilter": (["bbFilter", "pm.xmfa.backbone", "{o}.bbf", "--min-length=10"], ["{o}.bbf"]),
    "bbFilter-beast": (["bbFilter", "pm.xmfa.backbone", "{o}.bbf.xml", "--format=beast",
                        "--min-length=5"], ["{o}.bbf.xml"]),
    "bbFilter-genoplast": (["bbFilter", "pm.xmfa.backbone", "{o}.bbf.gp", "--format=genoplast",
                            "--min-length=5", "--names=a,b"], ["{o}.bbf.gp"]),
    "backbone_global_to_local": (["backbone_global_to_local", "pm.xmfa.backbone", "{o}.bbl",
                                  "a.fa", "b3.fa"], ["{o}.bbl"]),
    "calculateBackboneCoverage": (["calculateBackboneCoverage", "pm.xmfa", "50", "20", *PAIR],
                                  []),
    "calculateBackboneCoverage-rows": (["calculateBackboneCoverage", "pm.xmfa.backbone", *PAIR],
                                       []),
    "calculateBackboneCoverage2": (["calculateBackboneCoverage2", "pm.xmfa", "50", "50", *PAIR],
                                   []),
    "calculateCoverage": (["calculateCoverage", "pm.xmfa", *PAIR], []),
    "extractBackbone": (["extractBackbone", "a.fa,b.fa", "pm.xmfa", "50", "50", "{o}.eb.xmfa"],
                        ["{o}.eb.xmfa"]),
    "extractBackbone2": (["extractBackbone2", "pm.mln", "50", "50", "{o}.eb.mln", *PAIR],
                         ["{o}.eb.mln"]),
    "createBackboneMFA": (["createBackboneMFA", "pm.xmfa", "{o}.cb.mfa", "--stride=1", *PAIR],
                          ["{o}.cb.mfa"]),
    "createBackboneMFA-mln": (["createBackboneMFA", "pm.mln", "{o}.cbm.mfa", "--stride=2",
                               *PAIR], ["{o}.cbm.mfa"]),
    "createBackboneMFA-rows": (["createBackboneMFA", "pm.xmfa", "{o}.cbr.mfa",
                                "--rows=pm.xmfa.backbone", *PAIR], ["{o}.cbr.mfa"]),
    "checkForLGT": (["checkForLGT", "trees.nwk", "--group-a=a,b", "--group-b=c,d"], []),
    "getOrthologList": (["getOrthologList", "pm.xmfa", "pm.xmfa.backbone", "{o}.orthos",
                         "--cds-base={o}_cds", *GBK],
                        ["{o}.orthos", "{o}_cds_0.fas", "{o}_cds_1.fas"]),
    "randomGeneSample": (["randomGeneSample", "pm.xmfa", "pm.xmfa.backbone", "{o}_gs",
                          "--count=2", "--seed=5", *GBK], ["{o}_gs_0.fas", "{o}_gs_1.fas"]),
    "pairCompare": (["pairCompare", "pm.xmfa", "all_pairs/pair_0.1.xmfa", "--seqs", *PAIR], []),
    "pairCompare-count": (["pairCompare", "2", "--seqs", *PAIR], []),
    "uniqueMerCount": (["uniqueMerCount", "b.fa", "--seed-weight=9"], []),
    "rootTrees": (["rootTrees", "trees.nwk", "{o}.rooted", "--outgroup=c,d"], ["{o}.rooted"]),
    "uniquifyTrees": (["uniquifyTrees", "trees.nwk", "{o}.uniq"], ["{o}.uniq"]),
    "uniquifyTrees-nexus": (["uniquifyTrees", "t.trprobs", "{o}.uniqx"], ["{o}.uniqx"]),
    "extractBCITrees": (["extractBCITrees", "t.trprobs", "t.trprobs", "{o}.bci",
                         "--credibility=0.9", "--max-trees=2", "--seed=3"], ["{o}.bci"]),
}


def _same_tree(ref: str, got: str) -> None:
    """Two output directories hold the same files with the same bytes."""
    ref_files = sorted(os.path.relpath(os.path.join(r, f), ref)
                       for r, _, fs in os.walk(ref) for f in fs)
    got_files = sorted(os.path.relpath(os.path.join(r, f), got)
                       for r, _, fs in os.walk(got) for f in fs)
    assert ref_files and ref_files == got_files
    for f in ref_files:
        with open(os.path.join(ref, f), "rb") as a, open(os.path.join(got, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_identical(pair, case):
    """Every output file (a directory tree for getAlignmentWindows' default
    mode) and the standard output byte-identical between the packages."""
    argv, outputs = CASES[case]
    if case == "joinAlignmentFiles":
        run_both(pair, CASES["stripGapColumns"][0])
    files = [o for o in outputs if not o.endswith("_win")]
    out = run_both(pair, argv, outputs=files)
    for o in outputs:
        ref, got = (str(pair / o.replace("{o}", t)) for t in ("j", "t"))
        if o.endswith("_win"):
            _same_tree(ref, got)
        else:
            assert os.path.getsize(ref) > 0, o
    if not outputs:
        assert out.strip(), case


def test_outputs_carry_the_expected_content(pair):
    """The parity cases are not vacuous: unalign gives back both inputs,
    the ortholog table lists the complete CDS, the LGT test flags the mixed
    trees and the BCI set sums the duplicated file's posteriors."""
    from mauvealigner_tpu_torch.genome import read_fasta
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records

    with contextlib.chdir(pair):
        for case in ("unalign", "getOrthologList", "extractBCITrees"):
            run_both(pair, CASES[case][0], outputs=CASES[case][1])
        recs = read_fasta_records("t.un.mfa")
        assert [r.to_string() for r in recs] == [read_fasta(f).to_string() for f in PAIR]
        rows = open("t.orthos").read().splitlines()
        assert rows[0].startswith("OrthoID\tGI_in_Genome_0") and len(rows) >= 4
        lgt = run_both(pair, CASES["checkForLGT"][0]).split()
        assert lgt == ["clean", "clean", "LGT", "clean", "LGT"]
        bci = open("t.bci").read().splitlines()
        assert len(bci) == 2 and bci[0].startswith("[p=1.5]")


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    """A 6 kbp reference and a draft of four of its pieces shuffled, two of
    them reverse-complemented, one contig per FASTA record."""
    d = tmp_path_factory.mktemp("draft")
    rng = np.random.default_rng(43)
    ref = simulate.random_genome(rng, 6000, name="ref")
    der, _ = simulate.evolve(ref, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    cuts = [0, 1400, 3100, 4500, len(der)]
    pieces = [der.seq[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    order = [(2, False), (0, True), (3, False), (1, True)]
    contigs, parts, off = [], [], 0
    for i, flip in order:
        chunk = revcomp_ascii(pieces[i]) if flip else pieces[i]
        contigs.append(Contig(f"c{i}", len(chunk), off))
        parts.append(chunk)
        off += len(chunk)
    from mauvealigner_tpu_torch.genome import write_fasta

    write_fasta(ref, str(d / "ref.fa"))
    write_fasta(Genome(np.concatenate(parts), contigs=contigs, name="draft"), str(d / "draft.fa"))
    return d


def test_sort_contigs_identical(draft):
    """sortContigs: the reordered FASTA and the printed placement log
    byte-identical; the log places every contig in reference order."""
    out = run_both(draft, ["sortContigs", "ref.fa", "draft.fa", "--output={o}.sorted.fa",
                           "--seed-size=11"], outputs=["{o}.sorted.fa"])
    assert out.split() == ["c0", "-", "c1", "-", "c2", "+", "c3", "+"]


def test_sort_contigs_default_output_identical(draft, tmp_path):
    """Without --output both write <draft>.reordered; compared in two
    directories holding the same inputs."""
    outs = []
    for cli, sub in ((jax_cli, "j"), (torch_cli, "t")):
        d = tmp_path / sub
        d.mkdir()
        for f in ("ref.fa", "draft.fa"):
            (d / f).write_bytes((draft / f).read_bytes())
        extra = ["--device=cpu"] if sub == "t" else []
        with contextlib.chdir(d):
            assert cli(["sortContigs", "ref.fa", "draft.fa", "--seed-size=11", *extra]) == 0
        outs.append((d / "draft.fa.reordered").read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 6000


@pytest.mark.parametrize("tool", ["sortContigs", "uniqueMerCount"])
def test_device_tools_raise_without_gpu(draft, tool):
    """--device=cuda (the default) raises where torch sees no GPU: there
    is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda is a valid device here")
    argv = {"sortContigs": ["ref.fa", "draft.fa", "--output=x.fa"],
            "uniqueMerCount": ["ref.fa"]}[tool]
    with contextlib.chdir(draft), pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli([tool, *argv])
