"""Slice-1 parity: the port's MauveAligner (plain-torch path on the CPU)
writes XMFA byte-identical to the JAX package's, with the same anchors and
LCBs, through the API and through the mauveAligner CLI subcommand; and the
port never imports jax."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.models.aligner import MauveAligner as TorchAligner
from mauvealigner_tpu_torch.tools.cli import main as torch_cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xmfa(ivl) -> str:
    buf = io.StringIO()
    ivl.write_xmfa(buf)
    return buf.getvalue()


def _assert_parity(genomes, **opts):
    o = AlignerOptions(use_sml_cache=False, **opts)
    ref = MauveAligner(o).align(genomes)
    got = TorchAligner(interop.aligner_options(o, "cpu")).align(interop.genomes(genomes))
    assert np.array_equal(ref.mums.starts, got.mums.starts)
    assert np.array_equal(ref.mums.lengths, got.mums.lengths)
    assert [l.match_indices.tolist() for l in ref.lcbs] == [l.match_indices.tolist() for l in got.lcbs]
    assert _xmfa(ref.interval_list) == _xmfa(got.interval_list)
    return got


def _determinism_pair(rng, n=20000):
    """tests/test_determinism.py's input: 20 kbp, 2% divergence, inversion."""
    anc = simulate.random_genome(rng, n)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    c = der.codes.copy()
    c[8000:12000] = (3 - c[8000:12000])[::-1]
    return [anc, Genome(np.frombuffer(b"ACGTN", np.uint8)[np.minimum(c, 4)], name="der")]


def test_determinism_pair_xmfa_identical(rng):
    got = _assert_parity(_determinism_pair(rng), seed_size=11)
    assert len(got.lcbs) >= 2


def test_diverged_pair_with_recursion_xmfa_identical(rng):
    """Highly diverged stretches leave gaps for recursive anchoring and
    larger DP buckets."""
    anc = simulate.random_genome(rng, 20000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    c = der.codes.copy()
    for a, b in ((2000, 2600), (5000, 5800), (9000, 9600), (12000, 12700), (15300, 16000)):
        hit = rng.random(b - a) < 0.45
        c[a:b][hit] = (c[a:b][hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    c[15000:17000] = (3 - c[15000:17000])[::-1]
    _assert_parity([anc, Genome(np.frombuffer(b"ACGTN", np.uint8)[c], name="der")], seed_size=11)


def test_pairwise_identical_xmfa_identical(rng):
    g = simulate.random_genome(rng, 2000)
    got = _assert_parity([g, Genome(g.seq.copy(), name="copy")], seed_size=11)
    assert len(got.interval_list.intervals) == 1 and got.interval_list.intervals[0].aln.all()


@pytest.mark.parametrize("n", [1500, 4000])
def test_pairwise_mutated_xmfa_identical(rng, n):
    anc = simulate.random_genome(rng, n)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
    _assert_parity([anc, der], seed_size=11)


def test_pairwise_inversion_xmfa_identical(rng):
    anc = simulate.random_genome(rng, 6000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.005, ins_rate=0.0005, del_rate=0.0005)
    got = _assert_parity([anc, simulate.apply_inversion(der, 2000, 3500)], seed_size=11)
    assert sorted(int(l.strands[1]) for l in got.lcbs)[0] == -1


def test_ungapped_mode_xmfa_identical(rng):
    anc = simulate.random_genome(rng, 2000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
    _assert_parity([anc, der], seed_size=11, gapped=False, recursive=False)


def test_three_way_ungapped_xmfa_identical(rng):
    """Three genomes through every phase but the gapped closure (the gapped
    3-way run is in test_torch_progressive.py)."""
    anc = simulate.random_genome(rng, 3000)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    _assert_parity([anc, d1, d2], seed_size=9, gapped=False)


def test_ambiguity_runs_xmfa_identical(rng):
    anc = simulate.random_genome(rng, 8000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    seq = der.seq.copy()
    seq[1000:1030] = ord("N")
    seq[rng.random(len(seq)) < 0.002] = ord("N")
    _assert_parity([anc, Genome(seq, name="der")], seed_size=11)


def test_mid_pipeline_state_feeds_both_packages(rng):
    """Anchors and LCBs from the JAX package, carried across by interop,
    close into the same intervals in both packages."""
    genomes = _determinism_pair(rng, 12000)
    o = AlignerOptions(seed_size=11, use_sml_cache=False)
    ref_al = MauveAligner(o)
    ml = ref_al.find_mums(genomes)
    ml, lcbs = ref_al.determine_lcbs(genomes, ml)
    ref = ref_al.build_intervals(genomes, ml, lcbs)
    tg = interop.genomes(genomes)
    got = TorchAligner(interop.aligner_options(o, "cpu")).build_intervals(
        tg, interop.match_list(ml), interop.lcbs(lcbs)
    )
    assert _xmfa(ref) == _xmfa(got) == _xmfa(interop.interval_list(ref, tg))


def test_seq_profiles_raise(rng):
    """seq_profiles (the profile-aware closure, normalized count-profile DP)
    no longer raises: it gives the JAX package's XMFA on count profiles of
    a few member rows per side, with gaps that have an empty side and, under
    a cap of 8 columns, gaps over max_gapped_len (both emitted unaligned)."""
    anc = simulate.random_genome(rng, 3000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.03, ins_rate=0.002, del_rate=0.002)
    genomes = [anc, der]
    profiles = []
    for g in genomes:
        prof = np.zeros((len(g), 5), np.uint8)
        for _ in range(3):  # three noisy member rows voting per column
            codes = np.minimum(g.codes, 4).astype(np.int64)
            hit = rng.random(len(g)) < 0.1
            codes[hit] = rng.integers(0, 5, size=int(hit.sum()))
            np.add.at(prof, (np.arange(len(g)), codes), 1)
        profiles.append(prof)
    for cap in (4096, 8):
        o = AlignerOptions(seed_size=11, use_sml_cache=False, max_gapped_len=cap)
        ref = MauveAligner(o).align(genomes, seq_profiles=profiles)
        got = TorchAligner(interop.aligner_options(o, "cpu")).align(
            interop.genomes(genomes), seq_profiles=profiles
        )
        assert _xmfa(ref.interval_list) == _xmfa(got.interval_list)


def test_cli_outputs_identical(rng, tmp_path):
    paths = []
    for g, name in zip(_determinism_pair(rng, 12000), ("a.fa", "b.fa")):
        p = tmp_path / name
        p.write_bytes(b">" + g.name.encode() + b"\n" + g.seq.tobytes() + b"\n")
        paths.append(str(p))
    common = paths + ["--seed-size=11"]
    assert jax_cli(["mauveAligner", *common, f"--output={tmp_path}/j.mums",
                    f"--output-alignment={tmp_path}/j.xmfa"]) == 0
    assert torch_cli(["mauveAligner", *common, f"--output={tmp_path}/t.mums",
                      f"--output-alignment={tmp_path}/t.xmfa", "--device=cpu"]) == 0
    for ext in ("xmfa", "mums"):
        ref = (tmp_path / f"j.{ext}").read_bytes()
        assert len(ref) > 0 and ref == (tmp_path / f"t.{ext}").read_bytes()


def test_port_never_imports_jax():
    """Every module of the port, imported and its CLI subcommands' help
    printed, in a fresh interpreter: no jax and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mauvealigner_tpu_torch\n"
        "for m in pkgutil.walk_packages(mauvealigner_tpu_torch.__path__, 'mauvealigner_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from mauvealigner_tpu_torch.tools.cli import main\n"
        "for tool in ('mauveAligner', 'progressiveMauve'):\n"
        "    try:\n"
        "        main([tool, '--help'])\n"
        "    except SystemExit:\n"
        "        pass\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mauvealigner_tpu' or m.startswith('mauvealigner_tpu.')]\n"
        "print('LEAKED', bad) if bad else print('CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout and "usage: mauveAligner" in out.stdout, out.stdout
    assert "usage: progressiveMauve" in out.stdout, out.stdout
