"""The three-genome mauveAligner job (BASELINE config 2's command line) on
the CPU at 40 kbp: the benchmark's cell `threeway_ecoli.inverted` judged
correct, a wrong DP path judged not correct, and the hierarchical
closure's spans and counters (models/closure.py), which the pairwise fast
path never enters."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import capture, run, spec
from benchmark.traffic import generate
from mauvealigner_tpu_torch.ops import dp
from mauvealigner_tpu_torch.tools.cli import main as cli
from mauvealigner_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "threeway_ecoli.inverted"
LENGTH = 40_000
SEED = 2**32 + 19
HIER_SPANS = ("cl_hier", "cl_hier_profiles")
HIER_COUNTERS = ("cl_hier_code_merges", "cl_hier_profile_merges", "cl_hier_profile_cols")


@pytest.fixture(scope="module")
def cell():
    return spec.cell(CELL)


@pytest.fixture(scope="module")
def inputs(cell, tmp_path_factory):
    return generate.make_inputs(cell["config_data"], cell["traffic_data"], SEED,
                                str(tmp_path_factory.mktemp("threeway") / "in"), LENGTH)


def _job(argv, recorders=()):
    """One job of the command line on the CPU: (what the recorders saw,
    span calls, counters)."""
    captured = {}
    timing.GLOBAL.reset()
    with contextlib.redirect_stdout(io.StringIO()), capture.recording(recorders, captured):
        assert cli(list(argv) + ["--device=cpu"]) == 0
    return captured, dict(timing.GLOBAL.calls), dict(timing.GLOBAL.counters)


@pytest.fixture(scope="module")
def jobs(cell, inputs, tmp_path_factory):
    """Two jobs of the cell's command line on the same inputs; the first
    records its DP problems."""
    out = str(tmp_path_factory.mktemp("threeway_out"))
    work = cell["workload"]
    argv = run.expand(work["command"], inputs, out)
    outputs = dict(zip(work["outputs"], run.expand(work["outputs"].values(), inputs, out)))
    first = _job(argv, work["capture"])
    second = _job(argv)
    return outputs, first, second


def test_the_cell_runs_correct_through_the_harness():
    """In a process of its own: the harness refuses to print a result from
    a process that has loaded the JAX package, as this one has."""
    code = ("import io; from benchmark import run; "
            f"run.run({CELL!r}, {SEED}, 0.1, False, device='cpu', genome_length={LENGTH}, "
            "err=io.StringIO())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert {"job_s", "setup_s", "aligned_sn", "aligned_ppv"} <= set(result["metrics"])
    assert result["metrics"]["aligned_sn"]["value"] > 0.99


def test_a_planted_wrong_dp_path_fails_the_threeway_check(cell, inputs, jobs):
    outputs, (captured, _, _), _ = jobs
    checks, _ = run.judge(cell, inputs, outputs, "cpu", [{}], captured)
    assert all(v <= lim for v, lim in checks.values())
    calls = [dict(c) for c in captured["dp"]]
    # the first profile problem's path: its first diagonal step becomes a
    # gap in each sequence, which still consumes both sequences exactly
    k = next(i for i, c in enumerate(calls) if c["kind"] == "profiles")
    ops = [np.array(o) for o in calls[k]["ops"]]
    hit = int(np.flatnonzero(ops[0] == dp.OP_DIAG)[0])
    ops[0] = np.concatenate([ops[0][:hit], [dp.OP_UP, dp.OP_LEFT], ops[0][hit + 1:]]).astype(
        ops[0].dtype)
    calls[k]["ops"] = ops
    checks, _ = run.judge(cell, inputs, outputs, "cpu", [{}], {**captured, "dp": calls})
    assert checks["dp_gap"][0] > checks["dp_gap"][1]


def test_the_hierarchical_spans_and_counters_repeat_exactly(jobs):
    _, (_, calls1, counters1), (_, calls2, counters2) = jobs
    hier = {p: n for p, n in calls1.items() if p.split("/")[-1].startswith("cl_hier")}
    for name in HIER_SPANS:
        assert any(p.split("/")[-1] == name for p in hier), name
    assert hier == {p: calls2[p] for p in hier}
    # one code-pair round and one profile round, each entered once
    assert hier["gapped_closure/cl_hier"] == 1
    assert hier["gapped_closure/cl_hier/cl_hier_profiles"] == 1
    for name in HIER_COUNTERS:
        assert counters1[name] > 0 and counters1[name] == counters2[name], name


def test_a_pairwise_job_enters_no_hierarchical_span(inputs, tmp_path):
    out = str(tmp_path)
    argv = ["mauveAligner", *inputs.files[:2], f"--output={out}/m.mln",
            f"--output-alignment={out}/x.xmfa"]
    _, calls, counters = _job(argv)
    assert "gapped_closure" in calls
    assert not [p for p in calls if "cl_hier" in p]
    assert not [c for c in counters if c.startswith("cl_hier")]
    assert os.path.getsize(f"{out}/x.xmfa") > 0
