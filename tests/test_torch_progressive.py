"""Slice-2 parity: the port's ProgressiveMauve (plain-torch path on the CPU)
against the JAX package on the inputs of tests/test_progressive.py and
tests/test_tree_progressive.py — both branches of the auto gate, the
guide-tree file in and out, the profile-aware closure — plus 3-way
mauveAligner and the progressiveMauve CLI of both packages, whose XMFA,
.backbone, .bbcols and .guide_tree files must be byte-identical."""

import io

import numpy as np
import pytest
import torch

from mauvealigner_tpu.analysis.tree import write_newick as jax_write_newick
from mauvealigner_tpu.models import closure as jax_closure
from mauvealigner_tpu.models import refine as jax_refine
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu.utils import simulate, timing as jax_timing
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis.tree import write_newick
from mauvealigner_tpu_torch.models import closure, refine
from mauvealigner_tpu_torch.models.aligner import MauveAligner as TorchAligner
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve as TorchProgressive
from mauvealigner_tpu_torch.models.progressive import ProgressiveOptions as TorchOptions
from mauvealigner_tpu_torch.tools.cli import main as torch_cli
from mauvealigner_tpu_torch.utils import timing

torch.set_num_threads(1)


def _xmfa(ivl) -> str:
    buf = io.StringIO()
    ivl.write_xmfa(buf)
    return buf.getvalue()


def _segments(segs):
    return [(s.interval_index, s.col_start, s.col_end, list(s.seqs)) for s in segs]


def _assert_parity(genomes, o: ProgressiveOptions):
    """Both packages on the same genomes and options: same guide tree,
    LCBs, XMFA, backbone rows and segments, and the same gate branch."""
    jax_timing.GLOBAL.reset()
    ref = ProgressiveMauve(o).align(genomes)
    timing.GLOBAL.reset()
    got = TorchProgressive(interop.progressive_options(o, "cpu")).align(interop.genomes(genomes))
    assert ("tree_progressive" in jax_timing.GLOBAL.phases) == (
        "tree_progressive" in timing.GLOBAL.phases
    )
    assert jax_write_newick(ref.guide_tree) == write_newick(got.guide_tree)
    assert [l.match_indices.tolist() for l in ref.lcbs] == [l.match_indices.tolist() for l in got.lcbs]
    assert _xmfa(ref.interval_list) == _xmfa(got.interval_list)
    assert np.array_equal(ref.backbone_rows, got.backbone_rows)
    assert _segments(ref.backbone_segments) == _segments(got.backbone_segments)
    return got


def _three_way(rng):
    """tests/test_progressive.py::test_progressive_three_way_with_backbone."""
    anc = simulate.random_genome(rng, 2500)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    return [anc, d1, d2]


def _tree_branch_genomes(rng):
    """tests/test_tree_progressive.py::test_tree_progressive_end_to_end_with_inversion."""
    anc = simulate.random_genome(rng, 15_000)
    genomes = [anc]
    for i in range(3):
        d, t = simulate.evolve(anc, rng, sub_rate=0.10, ins_rate=0.006, del_rate=0.006, name=f"d{i}")
        if i == 1:
            d, t = simulate.apply_inversion_with_truth(d, t, 5000, 9000)
        genomes.append(d)
    return genomes


def test_three_way_with_backbone_identical(rng):
    got = _assert_parity(_three_way(rng), ProgressiveOptions(seed_weight=9, use_sml_cache=False))
    assert len(got.backbone_rows) > 0


def test_mid_pipeline_state_feeds_both_packages(rng):
    """A JAX alignment and guide tree, carried across by interop, give the
    same merge plan and the same refined alignment in both packages."""
    ref = ProgressiveMauve(ProgressiveOptions(
        seed_weight=9, use_sml_cache=False, refine=False, skip_backbone=True
    )).align(_three_way(rng))
    tree = interop.tree(ref.guide_tree)
    assert jax_write_newick(ref.guide_tree) == write_newick(tree)
    plan = closure.tree_plan(tree)
    assert plan == jax_closure.tree_plan(ref.guide_tree)
    for mode in ("split", "rebuild"):
        j_ivl, j_n = jax_refine.refine_intervals(ref.interval_list, plan, mode=mode)
        t_ivl, t_n = refine.refine_intervals(
            interop.interval_list(ref.interval_list), plan, mode=mode, device="cpu"
        )
        assert j_n == t_n and _xmfa(j_ivl) == _xmfa(t_ivl)


def test_guide_tree_output_identical(rng, tmp_path):
    """tests/test_progressive.py::test_progressive_guide_tree_output."""
    anc = simulate.random_genome(rng, 1500)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    ref_tree, got_tree = tmp_path / "j.nwk", tmp_path / "t.nwk"
    ProgressiveMauve(ProgressiveOptions(
        seed_weight=9, output_guide_tree=str(ref_tree), use_sml_cache=False
    )).align([anc, d1])
    TorchProgressive(interop.progressive_options(ProgressiveOptions(
        seed_weight=9, output_guide_tree=str(got_tree), use_sml_cache=False
    ), "cpu")).align(interop.genomes([anc, d1]))
    assert ref_tree.read_bytes() == got_tree.read_bytes()


@pytest.mark.parametrize("newick", ["((2,1),0);", "((1,2),3);", "((x,y),z);"])
def test_input_guide_tree_identical(rng, tmp_path, newick):
    """tests/test_progressive.py::test_input_guide_tree_label_conventions:
    the same leaf binding, and the same alignment along the given tree."""
    anc = simulate.random_genome(rng, 800)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    genomes = [anc, d1, d2]
    path = tmp_path / "in.nwk"
    path.write_text(newick)
    o = ProgressiveOptions(input_guide_tree=str(path), use_sml_cache=False, seed_weight=9)
    ref = ProgressiveMauve(o).guide_tree(genomes, None)
    got = TorchProgressive(interop.progressive_options(o, "cpu")).guide_tree(
        interop.genomes(genomes), None
    )
    assert ref.leaf_names() == got.leaf_names()
    assert jax_write_newick(ref) == write_newick(got)
    if newick.startswith("((2"):
        _assert_parity(genomes, o)


def test_tree_branch_with_inversion_identical(rng):
    got = _assert_parity(
        _tree_branch_genomes(rng), ProgressiveOptions(use_sml_cache=False, tree_progressive=True)
    )
    assert any(int(l.strands[2]) < 0 for l in got.lcbs if l.strands[2])


def test_profile_closure_identical(rng):
    """profile_closure=True: node merges align normalized clade count
    profiles (the normalize=True profile DP)."""
    anc = simulate.random_genome(rng, 6000)
    genomes = [anc] + [
        simulate.evolve(anc, rng, sub_rate=0.08, ins_rate=0.005, del_rate=0.005, name=f"d{i}")[0]
        for i in range(3)
    ]
    _assert_parity(genomes, ProgressiveOptions(
        use_sml_cache=False, tree_progressive=True, profile_closure=True, seed_weight=9,
    ))


def test_three_way_mauve_aligner_identical(rng):
    """mauveAligner on three genomes: the star closure's count-profile DP."""
    anc = simulate.random_genome(rng, 6000)
    genomes = [anc] + [
        simulate.evolve(anc, rng, sub_rate=0.03, ins_rate=0.002, del_rate=0.002)[0]
        for _ in range(2)
    ]
    o = AlignerOptions(use_sml_cache=False, seed_size=9)
    ref = MauveAligner(o).align(genomes)
    got = TorchAligner(interop.aligner_options(o, "cpu")).align(interop.genomes(genomes))
    assert _xmfa(ref.interval_list) == _xmfa(got.interval_list)


def test_mesh_and_missing_gpu_raise():
    """A mesh of more GPUs than are visible raises, as does cuda without a
    GPU; a JAX mesh converts to a port mesh of its size (tests of mesh runs:
    tests/test_torch_mesh_progressive.py)."""
    from mauvealigner_tpu.parallel import make_mesh as jax_make_mesh
    from mauvealigner_tpu_torch.parallel import make_mesh

    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"requested {n} devices"):
        make_mesh(n, device="cuda")
    converted = interop.progressive_options(ProgressiveOptions(mesh=jax_make_mesh(8)), "cpu")
    assert converted.mesh.size == 8 and converted.mesh.devices[0].type == "cpu"
    TorchProgressive(converted)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchProgressive(interop.progressive_options(ProgressiveOptions(), "cuda"))


def _fasta(tmp_path, genomes):
    paths = []
    for i, g in enumerate(genomes):
        p = tmp_path / f"g{i}.fa"
        p.write_bytes(b">" + f"g{i}".encode() + b"\n" + g.seq.tobytes() + b"\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("branch", ["extant", "tree"])
def test_cli_outputs_identical(rng, tmp_path, branch):
    if branch == "extant":
        genomes, flags = _three_way(rng), ["--seed-weight=9"]
    else:
        anc = simulate.random_genome(rng, 6000)
        genomes = [anc] + [
            simulate.evolve(anc, rng, sub_rate=0.08, ins_rate=0.005, del_rate=0.005)[0]
            for _ in range(3)
        ]
        flags = ["--seed-weight=9", "--tree-progressive=1"]
    paths = _fasta(tmp_path, genomes)
    assert jax_cli(["progressiveMauve", *paths, *flags, "--disable-cache",
                    f"--output={tmp_path}/j.xmfa"]) == 0
    assert torch_cli(["progressiveMauve", *paths, *flags, "--disable-cache", "--device=cpu",
                      f"--output={tmp_path}/t.xmfa"]) == 0
    for ext in ("", ".backbone", ".bbcols", ".guide_tree"):
        ref = (tmp_path / f"j.xmfa{ext}").read_bytes()
        got = (tmp_path / f"t.xmfa{ext}").read_bytes()
        if ext == "":  # the header names each package's own .bbcols file
            got = got.replace(b"t.xmfa.bbcols", b"j.xmfa.bbcols")
        assert len(ref) > 0 and ref == got, ext


def test_cli_mums_and_match_input_identical(rng, tmp_path):
    paths = _fasta(tmp_path, _three_way(rng))
    assert jax_cli(["progressiveMauve", *paths, "--seed-weight=9", "--disable-cache", "--mums",
                    f"--output={tmp_path}/j.mums"]) == 0
    assert torch_cli(["progressiveMauve", *paths, "--seed-weight=9", "--disable-cache",
                      "--device=cpu", "--mums", f"--output={tmp_path}/t.mums"]) == 0
    assert (tmp_path / "j.mums").read_bytes() == (tmp_path / "t.mums").read_bytes()
    assert jax_cli(["progressiveMauve", *paths, "--seed-weight=9", "--disable-cache",
                    f"--match-input={tmp_path}/j.mums", f"--output={tmp_path}/j.xmfa"]) == 0
    assert torch_cli(["progressiveMauve", *paths, "--seed-weight=9", "--disable-cache",
                      "--device=cpu", f"--match-input={tmp_path}/j.mums",
                      f"--output={tmp_path}/t.xmfa"]) == 0
    got = (tmp_path / "t.xmfa").read_bytes().replace(b"t.xmfa.bbcols", b"j.xmfa.bbcols")
    assert (tmp_path / "j.xmfa").read_bytes() == got
