"""Slice-6 parity for models/resume.py (the partitioned, journaled match
search, --merge-match-log and --realign-lcb): the cases of
tests/test_resume.py, each run through both packages on the same genomes,
with equal match tables and byte-identical journal, match-list and XMFA
files.  The port's searches run on the CPU (plain-torch path)."""


import numpy as np
import pytest
import torch

from mauvealigner_tpu.models import resume as jax_resume
from mauvealigner_tpu.seeds import get_seed as jax_get_seed
from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu.utils import simulate as jax_simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.core import mln
from mauvealigner_tpu_torch.models import resume
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.seeds import get_seed
from mauvealigner_tpu_torch.tools.cli import main as torch_cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """tests/test_resume.py's pair (JAX genomes) and the same genomes as
    the port's objects."""
    rng = np.random.default_rng(37)
    anc = jax_simulate.random_genome(rng, 2500)
    der, _ = jax_simulate.evolve(anc, rng, sub_rate=0.01)
    return (anc, der), tuple(interop.genomes([anc, der]))


def _table(ml):
    return ml.starts.tolist(), ml.lengths.tolist()


def _canon(ml):
    rows = np.concatenate([ml.starts, ml.lengths[:, None]], axis=1)
    return set(map(tuple, rows.tolist()))


def test_partitioned_equals_single_shot(pair):
    jg, tg = pair
    got = resume.resumable_find_mums(list(tg), get_seed(9, 0), n_partitions=4, device="cpu")
    ref = jax_resume.resumable_find_mums(list(jg), jax_get_seed(9, 0), n_partitions=4)
    assert _table(got) == _table(ref)
    full = MauveAligner(AlignerOptions(seed_size=9, use_sml_cache=False, device="cpu")).find_mums(
        list(tg))
    assert _canon(full) == _canon(got)


def test_mask_key_range_keeps_position_order():
    """The mask leaves every in-range key in place, in position order, and
    INVALID_KEY elsewhere (the order the port's device search needs)."""
    keys = torch.tensor([40, merops.INVALID_KEY, 7, 12, 41, 3, 12], dtype=torch.int64)
    pos = torch.arange(7, dtype=torch.int32)
    got_k, got_p = resume._mask_key_range(keys, pos, 7, 41)
    inv = merops.INVALID_KEY
    assert got_k.tolist() == [40, inv, 7, 12, inv, inv, 12]
    assert got_p.tolist() == list(range(7))


def test_resume_skips_completed_partitions(pair, tmp_path):
    jg, tg = pair
    logs = {}
    for tag, mod, genomes, seed, kw in (
        ("j", jax_resume, jg, jax_get_seed(9, 0), {}),
        ("t", resume, tg, get_seed(9, 0), {"device": "cpu"}),
    ):
        mlog, olog = str(tmp_path / f"{tag}.m.log"), str(tmp_path / f"{tag}.o.log")
        run = lambda: mod.resumable_find_mums(  # noqa: E731
            list(genomes), seed, n_partitions=3, match_log=mlog, offset_log=olog, **kw)
        full = run()
        assert mod.read_offset_log(olog) == [0, 1, 2]
        again = run()  # all partitions done: read straight from the journal
        with open(olog, "w") as fh:
            fh.write("0\n")
        partial = run()  # only partition 0 recorded
        assert _canon(full) == _canon(again) == _canon(partial)
        logs[tag] = (_table(full), _table(partial), open(mlog, "rb").read())
    assert logs["j"] == logs["t"]


def test_merge_match_logs(pair, tmp_path):
    jg, tg = pair
    ml = MauveAligner(AlignerOptions(seed_size=9, use_sml_cache=False, device="cpu")).find_mums(
        list(tg))
    half1 = ml.select(np.arange(len(ml)) % 2 == 0)
    half2 = ml.select(np.arange(len(ml)) % 2 == 1)
    log = str(tmp_path / "other.mln")
    mln.write_match_list(half2, log)
    merged = resume.merge_match_logs(half1, [log])
    assert _canon(merged) == _canon(ml)
    assert _table(merged) == _table(jax_resume.merge_match_logs(_to_jax(half1), [log]))


def _to_jax(ml):
    from mauvealigner_tpu.core.match import MatchList

    return MatchList(ml.starts.copy(), ml.lengths.copy())


def _write_pair(tmp_path, genomes, names):
    for g, name in zip(genomes, names):
        with open(tmp_path / name, "w") as fh:
            fh.write(f">{name}\n{g.seq.tobytes().decode()}\n")


def _both_clis(tmp_path, monkeypatch, argv, outputs):
    monkeypatch.chdir(tmp_path)
    assert jax_cli([a.replace("{o}", "j") for a in argv]) == 0
    assert torch_cli([a.replace("{o}", "t") for a in argv] + ["--device=cpu"]) == 0
    for name in outputs:
        ref = (tmp_path / name.replace("{o}", "j")).read_bytes()
        got = (tmp_path / name.replace("{o}", "t")).read_bytes()
        assert len(ref) > 0 and ref == got, name


def test_realign_lcb_cli(pair, tmp_path, monkeypatch):
    jg, _ = pair
    der_inv = jax_simulate.apply_inversion(jg[1], 800, 1600)
    _write_pair(tmp_path, [jg[0], der_inv], ["a.fa", "b.fa"])
    _both_clis(tmp_path, monkeypatch,
               ["mauveAligner", "a.fa", "b.fa", "--seed-size=9", "--output={o}.mln",
                "--output-alignment={o}.one_lcb.xmfa", "--realign-lcb=0"],
               ["{o}.one_lcb.xmfa"])
    from mauvealigner_tpu_torch.core.interval import IntervalList

    assert len(IntervalList.read_xmfa(str(tmp_path / "t.one_lcb.xmfa")).intervals) == 1


def test_match_input_cli(pair, tmp_path, monkeypatch):
    jg, _ = pair
    _write_pair(tmp_path, jg, ["a.fa", "b.fa"])
    _both_clis(tmp_path, monkeypatch,
               ["mauveAligner", "a.fa", "b.fa", "--seed-size=9", "--mums", "--output={o}.m.mln"],
               ["{o}.m.mln"])
    _both_clis(tmp_path, monkeypatch,
               ["mauveAligner", "a.fa", "b.fa", "--seed-size=9", "--match-input=j.m.mln",
                "--output={o}.m2.mln", "--output-alignment={o}.out.xmfa"],
               ["{o}.m2.mln", "{o}.out.xmfa"])


def test_match_log_cli(pair, tmp_path, monkeypatch):
    jg, _ = pair
    _write_pair(tmp_path, jg, ["a.fa", "b.fa"])
    _both_clis(tmp_path, monkeypatch,
               ["mauveAligner", "a.fa", "b.fa", "--seed-size=9", "--mums", "--partitions=3",
                "--match-log={o}.m.log", "--offset-log={o}.o.log", "--output={o}.m.mln"],
               ["{o}.m.log", "{o}.o.log", "{o}.m.mln"])
    assert resume.read_offset_log(str(tmp_path / "t.o.log")) == [0, 1, 2]
