"""Runs of the harness with the timed path broken underneath, or with the
control in the program's place: `correct` must come out false.  The look
for a card is skipped (device="cpu", small genomes); the rest of the run
is the one the benchmark makes."""

import io

import pytest

from benchmark import control, run

SIZES = {"pairwise_ecoli.gapped": 40_000, "progressive_entero9.tree": 20_000,
         "pairwise_ecoli.draft184": 1_000_000}
# (cell, kind, name, the checks that must fail)
CASES = [
    ("pairwise_ecoli.gapped", "fault", "dp_answer", {"closure_gap", "dp_gap"}),
    ("pairwise_ecoli.gapped", "fault", "dp_half", {"closure_gap", "dp_gap"}),
    ("pairwise_ecoli.gapped", "control", "lowp", {"dp_score_gap"}),
    ("pairwise_ecoli.gapped", "control", "sketch", {"anchor_miss"}),
    ("progressive_entero9.tree", "fault", "dp_answer", {"dp_gap"}),
    ("progressive_entero9.tree", "fault", "dp_half", {"dp_gap"}),
    ("progressive_entero9.tree", "fault", "hmm_answer", {"hmm_flips", "backbone_miss"}),
    ("progressive_entero9.tree", "control", "lowp", {"dp_gap", "hmm_flips"}),
    ("pairwise_ecoli.draft184", "fault", "placement", {"misplaced_share"}),
    ("pairwise_ecoli.draft184", "control", "sketch", {"anchor_miss"}),
]


def _run(workload, seed):
    return run.run(workload, seed, 0.1, False, device="cpu", genome_length=SIZES[workload],
                   out=io.StringIO(), err=io.StringIO())


@pytest.mark.parametrize("workload,kind,name,checks", CASES)
def test_a_broken_run_is_not_correct(workload, kind, name, checks):
    ctx = control.fault(name) if kind == "fault" else (
        control.lowp() if name == "lowp" else control.sketch())
    with ctx:
        result = _run(workload, 2**32 + 17)
    assert result["correct"] is False
    failed = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert checks <= failed and "jobs_differing" not in failed


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_same_run_unbroken_is_correct(workload):
    assert _run(workload, 2**32 + 17)["correct"] is True
