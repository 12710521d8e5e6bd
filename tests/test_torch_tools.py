"""Slice-6 parity: the port's command lines against the JAX package's.

Each test runs the same subcommand of both CLIs (the port's aligners with
--device=cpu, the plain-torch path) on the same files in one directory,
each package writing its own output names, and holds every output file and
the standard output byte for byte equal: the tools are the same host NumPy
in both packages, so nothing may differ.  Inputs are simulated from numpy
seeds (utils/simulate) and built once per module.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.ops import gotoh_cuda
from mauvealigner_tpu_torch.tools.cli import TOOLS
from mauvealigner_tpu_torch.tools.cli import main as torch_cli
from mauvealigner_tpu_torch.utils import simulate

torch.set_num_threads(1)

ALIGNERS = ("mauveAligner", "progressiveMauve")


def _write_fasta(path, g: Genome, name: str) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n{g.seq.tobytes().decode()}\n")


def _run(cli, argv, tag: str):
    """One CLI call with every "{o}" in argv replaced by tag; returns (rc,
    standard output)."""
    argv = [a.replace("{o}", tag) for a in argv]
    if tag == "t" and argv[0] in ALIGNERS:
        argv.append("--device=cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    return rc, buf.getvalue()


def run_both(path, argv, outputs=(), same_stdout=True):
    """Both CLIs in `path`; every name in `outputs` (with "{o}") must exist
    and be byte-identical between the two packages' runs."""
    with contextlib.chdir(path):
        rc_j, out_j = _run(jax_cli, argv, "j")
        rc_t, out_t = _run(torch_cli, argv, "t")
        assert rc_j == 0 and rc_t == 0
        if same_stdout:
            assert out_j.replace("j.", "t.").replace("j_", "t_") == out_t
        for name in outputs:
            ref = open(name.replace("{o}", "j"), "rb").read()
            got = open(name.replace("{o}", "t"), "rb").read()
            assert ref == got, name
    return out_t


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """Three 8 kbp genomes from one ancestor: g1 carries a 300 bp
    insertion (an island), g2 an inversion over 3000-4500 and a 250 bp
    deletion."""
    d = tmp_path_factory.mktemp("three")
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 8000)
    g1, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    g2, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    c1 = np.concatenate([g1.codes[:5500], rng.integers(0, 4, 300).astype(np.uint8),
                         g1.codes[5500:]])
    c2 = g2.codes.copy()
    c2[3000:4500] = (3 - c2[3000:4500])[::-1]
    c2 = np.concatenate([c2[:6200], c2[6450:]])
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    for i, g in enumerate((anc, Genome(acgt[c1]), Genome(acgt[c2]))):
        _write_fasta(d / f"g{i}.fa", g, f"g{i}")
    return d


SEQS = ["g0.fa", "g1.fa", "g2.fa"]
EVERY_OUTPUT = [
    "--output={o}.mln", "--output-alignment={o}.xmfa", "--island-size=50",
    "--island-output={o}.islands", "--backbone-size=50", "--backbone-output={o}.bb",
    "--id-matrix={o}.id", "--permutation-matrix-output={o}.perm",
    "--alignment-output-dir={o}_lcbs",
]


@pytest.fixture(scope="module")
def aligned(three):
    """mauveAligner of both packages with every output flag, once."""
    run_both(three, ["mauveAligner", *SEQS, "--seed-size=11", *EVERY_OUTPUT])
    return three


@pytest.mark.parametrize("ext", ["mln", "xmfa", "islands", "bb", "id", "perm"])
def test_mauve_aligner_every_output_identical(aligned, ext):
    ref = (aligned / f"j.{ext}").read_bytes()
    got = (aligned / f"t.{ext}").read_bytes()
    assert len(ref) > 0 and ref == got
    if ext == "islands":
        assert len(ref.splitlines()) >= 2  # the insertion and the deletion
    if ext == "perm":
        assert b"-" in ref  # the inversion


def test_mauve_aligner_per_lcb_files_identical(aligned):
    names = sorted(os.listdir(aligned / "j_lcbs"))
    assert len(names) >= 3 and names == sorted(os.listdir(aligned / "t_lcbs"))
    for n in names:
        assert (aligned / "j_lcbs" / n).read_bytes() == (aligned / "t_lcbs" / n).read_bytes()


@pytest.mark.parametrize("fmt", ["clustal", "phylip", "mfa"])
def test_mauve_aligner_dir_formats_identical(three, fmt):
    """The per-LCB formats, with the extension and recursion flags and the
    permutation weight floor (tests/test_tools.py's extension case)."""
    run_both(three, ["mauveAligner", *SEQS, "--seed-size=11", "--no-lcb-extension",
                     "--max-extension-iterations=2", "--min-recursive-gap-length=100",
                     "--output={o}.f.mln", f"--alignment-output-dir={{o}}_{fmt}",
                     f"--alignment-output-format={fmt}",
                     "--permutation-matrix-output={o}.f.perm",
                     "--permutation-matrix-min-weight=1", "--muscle-args=-maxiters 2",
                     "--island-break-min=5", "--id-matrix-input=unused"],
             outputs=["{o}.f.mln", "{o}.f.perm"] + [f"{{o}}_{fmt}/lcb_{i}.txt" for i in range(3)])


def test_mauve_aligner_mums_extras_identical(three):
    run_both(three, ["mauveAligner", *SEQS, "--seed-size=11", "--mums",
                     "--eliminate-overlaps", "--n-way-filter", "--output={o}.mums",
                     "--coverage-output={o}.cov", "--output-guide-tree={o}.nwk"],
             outputs=["{o}.mums", "{o}.cov", "{o}.nwk"])


def test_mauve_aligner_repeats_identical(three):
    run_both(three, ["mauveAligner", "g0.fa", "g1.fa", "--seed-size=11", "--repeats",
                     "--rmin=2", "--rmax=50", "--output={o}.reps"], outputs=["{o}.reps"])


def test_mauve_aligner_reentry_identical(aligned):
    """--lcb-input, and --match-input with --lcb-match-input, on an interval
    file written from the JAX run's alignment."""
    from mauvealigner_tpu.core import mln
    from mauvealigner_tpu.core.interval import IntervalList
    from mauvealigner_tpu.tools.common import load_genomes

    with contextlib.chdir(aligned):
        ivl = IntervalList.read_xmfa("j.xmfa")
        ivl.genomes = load_genomes(SEQS)
        mln.write_interval_list(ivl, "ivs.mln")
    run_both(aligned, ["mauveAligner", *SEQS, "--seed-size=11", "--lcb-input=ivs.mln",
                       "--output-alignment={o}.li.xmfa"], outputs=["{o}.li.xmfa"])
    run_both(aligned, ["mauveAligner", *SEQS, "--seed-size=11", "--match-input=ivs.mln",
                       "--lcb-match-input", "--output={o}.lmi.mln",
                       "--output-alignment={o}.lmi.xmfa"],
             outputs=["{o}.lmi.mln", "{o}.lmi.xmfa"])


def test_progressive_scratch_paths_hold_the_cache(three, tmp_path):
    """--scratch-path-1/-2: where a cache file cannot be written beside its
    sequence (a directory stands in its name), both packages write it into
    the first scratch path and read it back from there on the next run."""
    s1, s2 = tmp_path / "s1", tmp_path / "s2"
    s1.mkdir()
    s2.mkdir()
    from mauvealigner_tpu_torch.core import sml

    with contextlib.chdir(three):
        genomes = [f"g{k}.fa" for k in range(3)]
        argv = ["progressiveMauve", *genomes, "--seed-weight=11", "--output={o}.sp.xmfa",
                f"--scratch-path-1={s1}", f"--scratch-path-2={s2}"]
        # block the cache names beside the sequences (progressiveMauve's
        # default coding seed of weight 11)
        from mauvealigner_tpu_torch.seeds import CODING_SEED, get_seed

        pattern = get_seed(11, CODING_SEED).pattern
        for g in genomes:
            blocker = f"{g}.{pattern}.sslist.npz"
            if not os.path.isdir(blocker):
                os.mkdir(blocker)
        saved = list(sml._temp_paths)
        try:
            _, _ = _run(torch_cli, argv, "t")
            cached = sorted(os.listdir(s1))
            assert cached == sorted(f"{g}.{pattern}.sslist.npz" for g in genomes)
            assert not os.listdir(s2)
            stamp = {n: os.path.getmtime(s1 / n) for n in cached}
            _run(torch_cli, [a.replace(".sp.", ".sp2.") for a in argv], "t")
            assert {n: os.path.getmtime(s1 / n) for n in cached} == stamp  # read, not rebuilt
            _run(jax_cli, argv, "j")
            for suffix in ("", ".backbone", ".bbcols"):
                ref = open(f"j.sp.xmfa{suffix}", "rb").read()
                for t in ("t.sp", "t.sp2"):
                    got = open(f"{t}.xmfa{suffix}", "rb").read()
                    assert ref == got.replace(f"{t}.xmfa.bbcols".encode(), b"j.sp.xmfa.bbcols")
        finally:
            sml._temp_paths[:] = saved
            for g in genomes:
                os.rmdir(f"{g}.{pattern}.sslist.npz")


def test_progressive_apply_backbone_identical(three):
    """--apply-backbone re-enters with an XMFA and a .bbcols file (a pair:
    on three genomes the .bbcols columns, which index the LCBs before the
    backbone split them into the written blocks, pass a block's width in
    both packages, ROADMAP Queue C)."""
    pair = SEQS[:2]
    with contextlib.chdir(three):
        assert jax_cli(["progressiveMauve", *pair, "--seed-weight=11", "--disable-cache",
                        "--output=base.xmfa"]) == 0
    run_both(three, ["progressiveMauve", "base.xmfa", *pair,
                     "--apply-backbone=base.xmfa.bbcols", "--output={o}.ab.xmfa"],
             outputs=["{o}.ab.xmfa"])


@pytest.mark.parametrize("tool", ALIGNERS)
def test_mesh_devices_raise(three, tool):
    with contextlib.chdir(three), pytest.raises(NotImplementedError, match="ROADMAP A6"):
        torch_cli([tool, *SEQS, "--mesh-devices=2", "--output=x.xmfa", "--device=cpu"])


def test_tool_list(capsys):
    assert torch_cli(["--list"]) == 0
    listed = capsys.readouterr().out.split()[2:]
    assert len(listed) == len(TOOLS) == 23
    assert {"mauveAligner", "progressiveMauve", "repeatoire", "scoreAlignment", "evd",
            "multiEVD", "bbAnalyze", "bbBreakOnGenes", "gappiness", "xmfa2maf",
            "countInPlaceInversions"} <= set(listed)


@pytest.fixture(scope="module")
def alignment(three):
    """One XMFA (the JAX package's progressiveMauve of the three genomes)
    that every converter of both packages reads."""
    with contextlib.chdir(three):
        assert jax_cli(["progressiveMauve", *SEQS, "--seed-weight=11", "--disable-cache",
                        "--no-backbone", "--output=conv.xmfa"]) == 0
        with open("lens0.txt", "w") as fh:
            fh.write("3000 5000\n")
        with open("lens1.txt", "w") as fh:
            fh.write("8300\n")
        with open("lens2.txt", "w") as fh:
            fh.write("2000 5750\n")
    return three


CONVERTERS = {
    "xmfa2maf": (["conv.xmfa", "{o}.maf", *SEQS], ["{o}.maf"]),
    "mfa2xmfa": (["{mfa}", "{o}.m2x.xmfa", "{o}.unaligned.fa"],
                 ["{o}.m2x.xmfa", "{o}.unaligned.fa"]),
    "mauveToXMFA": (["{mln}", "{o}.m2x2.xmfa", *SEQS], ["{o}.m2x2.xmfa"]),
    "toMultiFastA": (["conv.xmfa", "{o}_block", *SEQS], ["{o}_block.lcb_0", "{o}_block.lcb_1"]),
    "toRawSequence": (["g1.fa", "{o}.raw"], ["{o}.raw"]),
    "multiToRawSequence": (["{mfa}", "{o}_raw"], ["{o}_raw0.raw", "{o}_raw2.raw"]),
    "toGBKsequence": (["g2.fa", "{o}.gbk"], ["{o}.gbk"]),
    "toGrimmFormat": (["conv.xmfa", "{o}.grimm", *SEQS,
                       "--chr-lengths=lens0.txt,lens1.txt,lens2.txt"], ["{o}.grimm"]),
    "toEvoHighwayFormat": (["conv.xmfa", "{o}.evo", *SEQS, "--ref-id=1",
                            "--chr-lengths=lens0.txt,lens1.txt,lens2.txt"], ["{o}.evo"]),
    "makeBadgerMatrix": (["conv.xmfa", "{o}.badger", "--lcb-coordinates={o}.coords", *SEQS],
                         ["{o}.badger", "{o}.coords"]),
    "makeMc4Matrix": (["conv.xmfa", "{o}.mc4", *SEQS], ["{o}.mc4"]),
    "countInPlaceInversions": (["conv.xmfa", *SEQS], []),
    "gappiness": (["{mfa}"], []),
}


@pytest.mark.parametrize("tool", sorted(CONVERTERS))
def test_converter_identical(alignment, tool):
    """Each converter subcommand on the same alignment (or the MFA / match
    file written from it): identical files and standard output."""
    from mauvealigner_tpu.core import mln
    from mauvealigner_tpu.core.interval import IntervalList
    from mauvealigner_tpu.tools.common import load_genomes
    from mauvealigner_tpu.tools.convert import to_multi_fasta

    with contextlib.chdir(alignment):
        ivl = IntervalList.read_xmfa("conv.xmfa", genomes=load_genomes(SEQS))
        if not os.path.exists("conv_lcb.lcb_0"):
            to_multi_fasta(ivl, "conv_lcb")  # aligned MFA of LCB 0, gaps kept
            mln.write_interval_list(ivl, "conv.ivs.mln")
    args, outs = CONVERTERS[tool]
    args = [a.replace("{mfa}", "conv_lcb.lcb_0").replace("{mln}", "conv.ivs.mln") for a in args]
    out = run_both(alignment, [tool, *args], outputs=outs)
    if tool == "gappiness":
        assert "aln_length\t" in out


def test_progressive_gap_above_4096_identical(tmp_path):
    """--max-gapped-aligner-length=6000 on a pair whose one unanchored gap
    (about 5.5 kbp of unrelated sequence on each side) exceeds 4096: the
    port closes it at DP side 8192 (on the card, the device-slab path of
    the codes kernel), the JAX package on its scan path above Pallas; the
    XMFA, .backbone and .bbcols files are byte-identical."""
    rng = np.random.default_rng(11)
    anc = simulate.random_genome(rng, 16000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    a, b = anc.seq.copy(), der.seq.copy()
    a[6000:11600] = simulate.random_genome(rng, 5600).seq
    b[6000:11500] = simulate.random_genome(rng, 5500).seq
    _write_fasta(tmp_path / "a.fa", Genome(a), "a.fa")
    _write_fasta(tmp_path / "b.fa", Genome(b), "b.fa")
    gotoh_cuda.reset_launches()
    with contextlib.chdir(tmp_path):
        argv = ["progressiveMauve", "a.fa", "b.fa", "--seed-weight=15", "--disable-cache",
                "--no-recursion", "--max-gapped-aligner-length=6000", "--output={o}.xmfa"]
        assert _run(jax_cli, argv, "j")[0] == 0
        assert _run(torch_cli, argv, "t")[0] == 0
    assert max(s["M"] for s in gotoh_cuda.LAUNCH_SHAPES) == 8192
    for suffix in ("", ".backbone", ".bbcols"):
        ref = (tmp_path / f"j.xmfa{suffix}").read_bytes()
        got = (tmp_path / f"t.xmfa{suffix}").read_bytes().replace(b"t.xmfa.bbcols", b"j.xmfa.bbcols")
        assert len(ref) > 0 and ref == got, suffix
