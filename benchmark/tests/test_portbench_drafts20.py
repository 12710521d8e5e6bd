"""The cell `drafts20_sharded.4chip` and its check, reference/drafts.py:
planted faults in sound outputs of sortContigs over three drafts each
raise their number over the cell's limit; marked `gpu`, the cell on four
cards."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from benchmark import capture, run, spec
from benchmark.reference import drafts as drafts_ref
from benchmark.reference import mln
from benchmark.traffic import generate

CELL = "drafts20_sharded.4chip"
LENGTH = 400_000  # 184 contigs of about 2.2 kbp
CARD_LENGTH = 1_000_000


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """The cell's traffic cut to three drafts at LENGTH, one job of the
    cell's command line on four logical CPU shards, and what the harness
    recorded of it."""
    from mauvealigner_tpu_torch.tools.cli import main as cli_main

    cell = spec.cell(CELL)
    traffic = {**cell["traffic_data"], "drafts": {**cell["traffic_data"]["drafts"], "count": 3}}
    tmp = tmp_path_factory.mktemp("drafts20")
    inputs = generate.make_inputs(cell["config_data"], traffic, 2**34 + 77, str(tmp / "in"),
                                  LENGTH)
    out = str(tmp / "out")
    os.makedirs(out)
    argv = run.expand(cell["workload"]["command"], inputs, out, 4) + ["--device=cpu"]
    outputs = {k: v for k, v in zip(cell["workload"]["outputs"],
                                    run.expand(cell["workload"]["outputs"].values(), inputs,
                                               out, 4))
               if not k.startswith("draft") or int(k[5:]) < 3}
    buf = io.StringIO()
    captured: dict = {}
    with contextlib.redirect_stdout(buf), capture.recording(["pair_mums"], captured):
        assert cli_main(argv) == 0
    with open(outputs["stdout"], "w") as fh:
        fh.write(buf.getvalue())
    return cell, inputs, outputs, captured


def _judge(cell, inputs, outputs, captured):
    numbers, report = drafts_ref.judge(inputs, outputs, captured, "cpu")
    limits = cell["workload"]["limits"]
    assert set(numbers) == set(limits)
    return {k: (v, limits[k]) for k, v in numbers.items()}, report


def _planted(tmp_path, outputs):
    """A copy of the outputs to break."""
    out = {}
    for k, path in outputs.items():
        out[k] = str(tmp_path / os.path.basename(path))
        shutil.copy(path, out[k])
    return out


def test_sound_outputs_pass(sound):
    cell, inputs, outputs, captured = sound
    checks, report = _judge(cell, inputs, outputs, captured)
    assert all(v <= lim for v, lim in checks.values()), checks
    assert report["drafts"] == 3 and report["contigs"] == 3 * 184
    assert report["contigs_in_place"] == pytest.approx(1 - checks["misplaced_share"][0])
    assert len(captured["pair_anchors"]) == 3
    # anchor_miss pools the counts behind mln.unanchored_share
    shares = [mln.unanchored_share(a, d.truth, len(g)) for a, d, g in
              zip(captured["pair_anchors"], inputs.drafts, inputs.genomes[1:])]
    sizes = [np.count_nonzero(d.truth[1:]) for d in inputs.drafts]
    assert checks["anchor_miss"][0] == pytest.approx(np.dot(shares, sizes) / sum(sizes),
                                                     abs=1e-12)
    assert checks["anchor_miss"][0] > 0


def _over(checks, name):
    value, limit = checks[name]
    return value > limit


def test_a_missing_draft_is_counted(sound, tmp_path):
    cell, inputs, outputs, captured = sound
    planted = _planted(tmp_path, outputs)
    os.remove(planted["draft1"])
    checks, _ = _judge(cell, inputs, planted, captured)
    assert checks["drafts_missing"][0] == 1
    # its contigs count as misplaced
    assert checks["misplaced_share"][0] >= 1 / 3
    # a draft whose block is missing from the log counts too
    planted = _planted(tmp_path, outputs)
    name = os.path.basename(inputs.files[3])
    lines = open(planted["stdout"]).read().splitlines(keepends=True)
    head = next(i for i, x in enumerate(lines) if x.rstrip("\n").endswith(name))
    open(planted["stdout"], "w").writelines(lines[:head])
    checks, _ = _judge(cell, inputs, planted, captured)
    assert checks["drafts_missing"][0] == 1


def test_a_duplicated_contig_is_bad(sound, tmp_path):
    cell, inputs, outputs, captured = sound
    planted = _planted(tmp_path, outputs)
    text = open(planted["draft2"]).read()
    second = text.index(">", 1)
    open(planted["draft2"], "w").write(text + text[:second])
    checks, _ = _judge(cell, inputs, planted, captured)
    assert _over(checks, "bad_contigs")


def test_a_flipped_strand_is_bad(sound, tmp_path):
    cell, inputs, outputs, captured = sound
    planted = _planted(tmp_path, outputs)
    lines = open(planted["stdout"]).read().splitlines(keepends=True)
    k = next(i for i, x in enumerate(lines) if x.endswith("\t+\n"))
    lines[k] = lines[k].replace("\t+", "\t-")
    open(planted["stdout"], "w").writelines(lines)
    checks, _ = _judge(cell, inputs, planted, captured)
    assert _over(checks, "bad_contigs")


def test_an_empty_anchor_array_counts_its_draft_unanchored(sound):
    cell, inputs, outputs, captured = sound
    rows = list(captured["pair_anchors"])
    rows[1] = rows[1][:0]
    checks, _ = _judge(cell, inputs, outputs, {**captured, "pair_anchors": rows})
    assert _over(checks, "anchor_miss") and checks["anchor_miss"][0] > 0.3
    # no array at all for the last draft: the same
    checks, _ = _judge(cell, inputs, outputs, {**captured, "pair_anchors": rows[:2]})
    assert checks["anchor_miss"][0] > 0.6


@pytest.mark.gpu
def test_the_cell_runs_on_four_cards(cuda):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    result = run.run(CELL, 2**33 + 101, 1.0, True, genome_length=CARD_LENGTH,
                     out=io.StringIO(), err=io.StringIO())
    device = result["device"]
    assert result["correct"] is True and result["failed"] == 0
    assert device["count"] == 4
    assert len(device["memory_peak_bytes_by_device"]) == len(device["busy_s_by_device"]) == 4
    assert all(x > 0 for x in device["memory_peak_bytes_by_device"] + device["busy_s_by_device"])
    for name in ("pair_sml_s", "pair_tables_s", "drafts_lcb_s", "extend_s"):
        assert name in result["metrics"], name
    assert np.isfinite(result["metrics"]["pair_tables_s"]["value"])
