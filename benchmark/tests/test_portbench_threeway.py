"""The three-genome check (reference/threeway.py) against a tiny
mauveAligner job of cell `threeway_ecoli.inverted`: the program's files
pass, and a copy of the XMFA with a changed base, a shifted anchor or a
row left out fails."""

import contextlib
import io
import os

import numpy as np
import pytest

from benchmark import capture, run, spec
from benchmark.traffic import generate

CELL = "threeway_ecoli.inverted"


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from mauvealigner_tpu_torch.tools.cli import main

    tmp = tmp_path_factory.mktemp("threeway")
    cell = spec.cell(CELL)
    work = cell["workload"]
    inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], 2**33 + 7,
                                  str(tmp / "in"), 40_000)
    out = str(tmp / "out")
    os.makedirs(out)
    argv = run.expand(work["command"], inputs, out) + ["--device=cpu"]
    outputs = dict(zip(work["outputs"], run.expand(work["outputs"].values(), inputs, out)))
    captured = {}
    with contextlib.redirect_stdout(io.StringIO()), capture.recording(work["capture"], captured):
        assert main(argv) == 0
    return cell, inputs, outputs, captured


def _failed(cell, inputs, outputs, captured):
    checks, _ = run.judge(cell, inputs, outputs, "cpu", [{}], captured)
    return {k for k, (v, lim) in checks.items() if v > lim}


def _planted(outputs, tmp_path, edit):
    path = str(tmp_path / "planted.xmfa")
    with open(outputs["xmfa"]) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(edit(text))
    return {**outputs, "xmfa": path}


def _row_span(lines, row):
    """(header line, end line) of the row-th XMFA row."""
    h = [i for i, l in enumerate(lines) if l.startswith(">")][row]
    end = h + 1
    while end < len(lines) and lines[end] and lines[end][0] not in ">=":
        end += 1
    return h, end


def _edit_row(text, row, fn):
    lines = text.split("\n")
    h, end = _row_span(lines, row)
    seq = fn("".join(lines[h + 1:end]))
    lines[h + 1:end] = [seq[i:i + 80] for i in range(0, len(seq), 80)]
    return "\n".join(lines)


def _widest_block_rows(text):
    """{genome: row number} of the block with the longest rows."""
    lines = text.split("\n")
    block, best = {}, (0, {})
    for k in range(sum(l.startswith(">") for l in lines)):
        h, end = _row_span(lines, k)
        block[int(lines[h][1:].split(":")[0]) - 1] = k
        if end < len(lines) and lines[end].startswith("="):
            width = len("".join(lines[h + 1:end]))
            if width > best[0]:
                best = (width, block)
            block = {}
    return best[1]


def test_the_programs_files_pass(job):
    assert _failed(*job) == set()


def test_a_changed_base_fails(job, tmp_path):
    cell, inputs, outputs, cap = job
    swap = {"A": "C", "C": "G", "G": "T", "T": "A"}

    def change(seq):
        i = next(k for k in range(100, len(seq)) if seq[k] in swap)
        return seq[:i] + swap[seq[i]] + seq[i + 1:]

    bad = _planted(outputs, tmp_path, lambda t: _edit_row(t, 2, change))
    assert "bad_rows" in _failed(cell, inputs, bad, cap)


def test_a_shifted_anchor_fails(job, tmp_path):
    cell, inputs, outputs, cap = job
    # five columns of genome 1's row shifted right by one: a gap opened in
    # every row around them keeps each row's bases and the block's width
    rows = _widest_block_rows(open(outputs["xmfa"]).read())
    at = 3000

    def shifted(t):
        t = _edit_row(t, rows[0], lambda s: s[:at] + "-" + s[at:])
        t = _edit_row(t, rows[1], lambda s: s[:at + 6] + "-" + s[at + 6:])
        return _edit_row(t, rows[2], lambda s: s[:at] + "-" + s[at:])

    failed = _failed(cell, inputs, _planted(outputs, tmp_path, shifted), cap)
    assert {"closure_gap", "anchors_unaligned"} <= failed
    assert not failed & {"bad_rows", "ragged_blocks", "bases_twice"}


@pytest.mark.parametrize("genome", [0, 1, 2])
def test_a_row_left_out_fails(job, tmp_path, genome):
    cell, inputs, outputs, cap = job
    row = _widest_block_rows(open(outputs["xmfa"]).read())[genome]

    def left_out(text):
        lines = text.split("\n")
        h, end = _row_span(lines, row)
        return "\n".join(lines[:h] + lines[end:])

    failed = _failed(cell, inputs, _planted(outputs, tmp_path, left_out), cap)
    assert "anchors_unaligned" in failed


def _unaligned_group_xmfa(path, side, rng):
    """A block of three genomes: a 50-base anchor, then a gap region of
    `side` random bases per genome emitted unaligned (genome 0's bases
    against gaps, then genome 1's, then genome 2's), then another anchor.
    Returns the match rows of the two anchors."""
    anchor = [rng.choice(list("ACGT"), 50) for _ in range(2)]
    regions = [rng.choice(list("ACGT"), side) for _ in range(3)]
    rows = []
    for g in range(3):
        text = ["".join(anchor[0])]
        for k in range(3):
            text.append("".join(regions[g]) if k == g else "-" * side)
        text.append("".join(anchor[1]))
        rows.append("".join(text))
    n = 100 + side
    with open(path, "w") as fh:
        fh.write("#FormatVersion Mauve1\n")
        for g, row in enumerate(rows):
            fh.write(f"> {g + 1}:1-{n} + g{g}.fa\n")
            fh.writelines(row[i:i + 80] + "\n" for i in range(0, len(row), 80))
        fh.write("=\n")
    return np.array([[50, 1, 1, 1], [50, 51 + side, 51 + side, 51 + side]], np.int64)


@pytest.mark.parametrize("side,scored", [(3000, False), (100, True)])
def test_a_group_left_unaligned_is_scored_only_under_the_width_limit(tmp_path, side, scored):
    """The program leaves a group unaligned where the first merge's width
    passes 4096 (two sides of 3000 do); two sides of 100 it must align."""
    from benchmark.reference import threeway, xmfa

    path = str(tmp_path / "x.xmfa")
    matches = _unaligned_group_xmfa(path, side, np.random.default_rng(side))
    gap, counts = threeway.closure_gaps(xmfa.read_xmfa(path), matches, 100 + side, "cpu")
    assert counts["width_unaligned_pieces"] == (0 if scored else 1)
    assert (len(gap) == 1 and gap[0] > 0) if scored else len(gap) == 0


@pytest.mark.parametrize("kind,name,checks", [
    ("fault", "dp_answer", {"closure_gap", "dp_gap"}),
    ("fault", "dp_half", {"closure_gap", "dp_gap"}),
    ("control", "lowp", {"dp_score_gap"}),
    ("control", "sketch", {"anchor_miss"}),
])
def test_a_broken_run_of_the_cell_is_not_correct(kind, name, checks):
    from benchmark import control

    ctx = control.fault(name) if kind == "fault" else (
        control.lowp() if name == "lowp" else control.sketch())
    with ctx:
        result = run.run(CELL, 2**32 + 17, 0.1, False, device="cpu", genome_length=40_000,
                         out=io.StringIO(), err=io.StringIO())
    assert result["correct"] is False
    failed = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert checks <= failed and "jobs_differing" not in failed


def test_the_span_readers_find_cl_hier_at_any_depth():
    jobs = [{"gapped_closure": 3.0, "gapped_closure/cl_hier": 2.0,
             "gapped_closure/cl_hier/cl_hier_profiles": 0.5,
             "refinement/rf_closure/cl_hier": 1.0},
            {"gapped_closure/cl_hier": 1.0, "gapped_closure/cl_hier/cl_hier_profiles": 0.25}]
    ctx = {"phases": jobs}
    assert spec.metric_reader("hier_closure_s").read(ctx) == pytest.approx(2.0)
    assert spec.metric_reader("hier_profiles_s").read(ctx) == pytest.approx(0.375)
    # the parent's spans: none of these names, so nothing to read
    parent = {"phases": [{"gapped_closure": 3.0, "gapped_closure/cl_hier_setup": 1.0}]}
    assert spec.metric_reader("hier_closure_s").read(parent) is None
    assert spec.metric_reader("hier_profiles_s").read(parent) is None
