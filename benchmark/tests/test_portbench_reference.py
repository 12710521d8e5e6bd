"""The plain reference against tiny inputs: the program's files pass, and
a defect planted in a copy of one of them fails the comparison."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from benchmark import capture, run, spec
from benchmark.traffic import generate

SIZES = {"pairwise_ecoli.gapped": 40_000, "progressive_entero9.tree": 20_000,
         "pairwise_ecoli.draft184": 1_000_000}


def _job(tmp_path, workload):
    from mauvealigner_tpu_torch.tools.cli import main

    cell = spec.cell(workload)
    work = cell["workload"]
    inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], 2**33 + 5,
                                  str(tmp_path / "in"), SIZES[workload])
    out = str(tmp_path / "out")
    os.makedirs(out)
    argv = run.expand(work["command"], inputs, out) + ["--device=cpu"]
    outputs = dict(zip(work["outputs"], run.expand(work["outputs"].values(), inputs, out)))
    captured, buf = {}, io.StringIO()
    with contextlib.redirect_stdout(buf), capture.recording(work.get("capture", []), captured):
        assert main(argv) == 0
    if "stdout" in outputs:
        with open(outputs["stdout"], "w") as fh:
            fh.write(buf.getvalue())
    return cell, inputs, outputs, captured


def _failed(cell, inputs, outputs, captured):
    checks, _ = run.judge(cell, inputs, outputs, "cpu", [{}], captured)
    return {k for k, (v, lim) in checks.items() if v > lim}


def _planted(outputs, key, tmp_path, edit):
    """A copy of outputs[key] with `edit` applied to its text."""
    path = str(tmp_path / ("planted_" + os.path.basename(outputs[key])))
    with open(outputs[key]) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(edit(text))
    return {**outputs, key: path}


@pytest.fixture(scope="module")
def gapped(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("gapped"), "pairwise_ecoli.gapped")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("tree"), "progressive_entero9.tree")


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("draft"), "pairwise_ecoli.draft184")


@pytest.mark.parametrize("which", ["gapped", "tree", "draft"])
def test_the_programs_files_pass(request, which):
    assert _failed(*request.getfixturevalue(which)) == set()


def _rows(text):
    """(header line index, first and last sequence line index) per row."""
    lines = text.split("\n")
    heads = [i for i, l in enumerate(lines) if l.startswith(">")]
    return lines, heads


def _edit_row(text, row, fn):
    """Apply fn to the joined sequence text of the row-th XMFA row."""
    lines, heads = _rows(text)
    h = heads[row]
    end = h + 1
    while end < len(lines) and lines[end] and lines[end][0] not in ">=":
        end += 1
    seq = fn("".join(lines[h + 1:end]))
    lines[h + 1:end] = [seq[i:i + 80] for i in range(0, len(seq), 80)]
    return "\n".join(lines)


def test_a_changed_base_fails(gapped, tmp_path):
    cell, inputs, outputs, cap = gapped
    swap = {"A": "C", "C": "G", "G": "T", "T": "A"}

    def change(seq):
        i = next(k for k in range(100, len(seq)) if seq[k] in swap)
        return seq[:i] + swap[seq[i]] + seq[i + 1:]

    bad = _planted(outputs, "xmfa", tmp_path, lambda t: _edit_row(t, 1, change))
    assert "bad_rows" in _failed(cell, inputs, bad, cap)


def test_a_shifted_anchor_fails(gapped, tmp_path):
    cell, inputs, outputs, cap = gapped
    # five columns of the second row shifted right by one: a gap opened in
    # each row around them keeps every row's bases and every block's width
    at = 3000
    first = _planted(outputs, "xmfa", tmp_path,
                     lambda t: _edit_row(_edit_row(t, 0, lambda s: s[:at] + "-" + s[at:]),
                                         1, lambda s: s[:at + 6] + "-" + s[at + 6:]))
    assert _failed(cell, inputs, first, cap) == {"closure_gap"}


def test_a_moved_gap_column_fails(gapped, tmp_path):
    cell, inputs, outputs, cap = gapped

    def move(seq):
        # the first gap of the row, moved ten columns to the left
        i = seq.index("-")
        return seq[:i - 10] + "-" + seq[i - 10:i] + seq[i + 1:]

    lines, heads = _rows(open(outputs["xmfa"]).read())
    row = 0 if "-" in "".join(lines[heads[0] + 1:heads[1]]) else 1
    bad = _planted(outputs, "xmfa", tmp_path, lambda t: _edit_row(t, row, move))
    assert "closure_gap" in _failed(cell, inputs, bad, cap)


def test_a_block_written_twice_fails(gapped, tmp_path):
    cell, inputs, outputs, cap = gapped

    def twice(text):
        head, _, body = text.partition("\n>")
        return head + "\n>" + body + ">" + body
    bad = _planted(outputs, "xmfa", tmp_path, twice)
    assert "bases_twice" in _failed(cell, inputs, bad, cap)


def test_anchors_left_out_fail(gapped, tmp_path):
    cell, inputs, outputs, cap = gapped

    def half(text):
        lines = text.split("\n")
        return "\n".join(l for k, l in enumerate(lines) if not (l[:1].isdigit() and k % 2))
    bad = _planted(outputs, "mln", tmp_path, half)
    assert "anchor_miss" in _failed(cell, inputs, bad, cap)


def test_a_flipped_contig_fails(draft, tmp_path):
    cell, inputs, outputs, cap = draft

    def flip(text):
        recs = text.split(">")
        name, _, seq = recs[2].partition("\n")
        rc = generate.revcomp(np.frombuffer(seq.replace("\n", "").encode(), np.uint8))
        recs[2] = name + "\n" + rc.tobytes().decode() + "\n"
        return ">".join(recs)
    bad = _planted(outputs, "fasta", tmp_path, flip)
    assert "bad_contigs" in _failed(cell, inputs, bad, cap)


def test_a_flipped_strand_in_the_log_fails(draft, tmp_path):
    cell, inputs, outputs, cap = draft

    def flip(text):
        lines = text.split("\n")
        name, mark = lines[0].split("\t")
        lines[0] = name + "\t" + ("-" if mark == "+" else "+")
        return "\n".join(lines)
    bad = _planted(outputs, "stdout", tmp_path, flip)
    assert "bad_contigs" in _failed(cell, inputs, bad, cap)


def test_anchors_of_a_sampled_search_fail(draft):
    cell, inputs, outputs, cap = draft
    thin = {"anchors": cap["anchors"][::4]}
    assert "anchor_miss" in _failed(cell, inputs, outputs, thin)


def test_a_backbone_row_off_the_genome_fails(tree, tmp_path):
    cell, inputs, outputs, cap = tree

    def off(text):
        lines = text.split("\n")
        fields = lines[1].split("\t")
        fields[1] = str(len(inputs.genomes[0]) + 10)
        lines[1] = "\t".join(fields)
        return "\n".join(lines)
    bad = _planted(outputs, "backbone", tmp_path, off)
    assert "backbone_bad_rows" in _failed(cell, inputs, bad, cap)


def test_a_row_left_out_fails(tree, tmp_path):
    cell, inputs, outputs, cap = tree

    def drop(text):
        lines, heads = _rows(text)
        h = heads[0]
        end = h + 1
        while lines[end][0] not in ">=":
            end += 1
        return "\n".join(lines[:h] + lines[end:])
    bad = _planted(outputs, "xmfa", tmp_path, drop)
    assert "bases_unaligned" in _failed(cell, inputs, bad, cap)


def _split_first_diagonal(ops):
    """A path with its first diagonal step replaced by two gaps."""
    d = np.flatnonzero(ops == 1)
    if not len(d):
        return ops
    return np.concatenate([ops[:d[0]], [2, 3], ops[d[0] + 1:]]).astype(ops.dtype)


def test_a_worse_dp_path_fails(tree):
    cell, inputs, outputs, cap = tree
    calls = [{**call, "ops": [_split_first_diagonal(o) for o in call["ops"]]}
             for call in cap["dp"]]
    assert "dp_gap" in _failed(cell, inputs, outputs, {"dp": calls})
