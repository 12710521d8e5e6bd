"""The harness: files found by name, the result line, the window, the
import guard and the look for a card."""

import ast
import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import run, spec

ROOT = spec.ROOT
SMALL = {"pairwise_ecoli.gapped": 30_000, "progressive_entero9.tree": 20_000,
         "pairwise_ecoli.draft184": 1_000_000}
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def test_every_cell_config_and_metric_loads_by_name():
    bench = spec.benchmark()
    assert {w["name"] for w in bench["workloads"]} == set(spec.names("workloads"))
    assert {c["name"] for c in bench["configs"]} <= set(spec.names("configs"))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config_data"]["name"] == w["config"]
        assert cell["traffic_data"]["shape"] in ("descendants", "draft", "drafts")
        assert {m["name"] for m in cell["end_to_end"]} >= {"job_s", "setup_s"}
        assert cell["per_layer"]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(spec.metric_reader(m["name"]).read)


def test_per_layer_metrics_move_job_s_in_cells_that_report_it():
    bench = spec.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] == "job_s"
        for w in m.get("workloads", cells):
            assert "job_s" in {e["name"] for e in spec.cell(w)["end_to_end"]}
    # a metric without a list of cells is read in every cell that reports
    # the metric it moves
    for w in cells:
        names = {m["name"] for m in spec.cell(w)["per_layer"]}
        assert {"device_idle_share", "peak_device_gib"} <= names


def test_a_new_cell_and_metric_are_picked_up_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "pairwise_ecoli.extra", "config": "mauve_pairwise_ecoli",
                               "traffic": "gapped", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "extra_s", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "a test layer",
                               "moves": "job_s", "workloads": ["pairwise_ecoli.extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    work = json.loads((root / "benchmark/workloads/pairwise_ecoli.gapped.json").read_text())
    (root / "benchmark/workloads/pairwise_ecoli.extra.json").write_text(json.dumps(work))
    (root / "benchmark/metrics/extra_s.py").write_text('def read(ctx):\n    return 1.5\n')
    assert "pairwise_ecoli.extra" in spec.names("workloads", str(root))
    cell = spec.cell("pairwise_ecoli.extra", str(root))
    # the new cell also reports the metrics that go with every cell's job_s
    assert [m["name"] for m in cell["per_layer"]] == [
        "device_idle_share", "peak_device_gib", "extra_s"]
    assert spec.metric_reader("extra_s", str(root)).read({}) == 1.5


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_result_keys(trace):
    out, err = io.StringIO(), io.StringIO()
    result = run.run("pairwise_ecoli.gapped", 2**31 + 11, 0.2, trace, device="cpu",
                     genome_length=SMALL["pairwise_ecoli.gapped"], out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == list(REQUIRED)
    # the numbers compared, each beside its limit, come last
    assert keys[-1] == "checks"
    assert set(keys) == set(REQUIRED) | {"checks"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.cell("pairwise_ecoli.gapped")
    want = {m["name"] for m in cell["per_layer" if trace else "end_to_end"]}
    # device metrics have nothing to read on the CPU
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for name, value in line["checks"].items():
        assert set(value) == {"value", "limit"}
    last = err.getvalue().strip().splitlines()[-1]
    assert last.startswith(f"check {list(line['checks'])[-1]}:")
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])


def test_the_window_counts_the_job_in_flight():
    def job():
        time.sleep(0.3)
        return 0

    walls, rcs, window = run.timed_window(job, 0.5)
    # jobs start at 0 and 0.3 s; the second is in flight at 0.5 s and counts
    assert len(walls) == 2 and rcs == [0, 0]
    assert window >= sum(walls) >= 0.6


def test_a_timed_job_that_does_less_work_is_not_correct(monkeypatch):
    """Timed jobs that reuse the warm job's DP answers instead of solving
    them write the warm job's bytes; their work, counted per job, must
    still equal the warm job's."""
    from mauvealigner_tpu_torch.ops import dp

    answers: dict = {}
    served = {"n": 0}
    solve = dp.align_code_pairs_batch_async

    def reused(a, b, la, lb, *args, **kwargs):
        key = (bytes(a), bytes(b), bytes(la), bytes(lb))
        if key in answers:
            served["n"] += 1
        else:
            answers[key] = solve(a, b, la, lb, *args, **kwargs)()
        got = answers[key]
        return lambda: got

    # dp._align_pairs, which batches every closure's DP, launches through this name
    monkeypatch.setattr(dp, "align_code_pairs_batch_async", reused)
    result = run.run("pairwise_ecoli.gapped", 2**31 + 11, 0.2, False, device="cpu",
                     genome_length=SMALL["pairwise_ecoli.gapped"], out=io.StringIO(),
                     err=io.StringIO())
    assert served["n"] >= 1
    checks = result["checks"]
    assert checks["jobs_differing"]["value"] == 0
    assert checks["jobs_work_differing"]["value"] >= 1
    assert result["correct"] is False


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    modules = dict(sys.modules)
    for name in ("jax", "jaxlib", "flax", "mauvealigner_tpu"):
        modules.pop(name, None)
    modules = {k: v for k, v in modules.items() if k.split(".")[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", {**modules, "mauvealigner_tpu_torch.ops": sys,
                                         "jax_like": sys})
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mauvealigner_tpu.ops.dp", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib", "mauvealigner_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    banned = set(run.FORBIDDEN)
    for folder, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(folder, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & banned, path
                if os.sep + "reference" + os.sep in path:
                    assert "mauvealigner_tpu_torch" not in tops, path


def _no_card_env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_exits_nonzero_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pairwise_ecoli.gapped",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=_no_card_env(), timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "run.run('pairwise_ecoli.gapped', 1, 0.1, False, device='cpu', genome_length=20000)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env=_no_card_env(), timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "mauvealigner_tpu_torch" in proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    out = io.StringIO()
    result = run.run(workload, 2**31 + 7, 1.0, False, out=out, err=io.StringIO())
    assert result["correct"] and result["device"]["platform"] == "gpu"
