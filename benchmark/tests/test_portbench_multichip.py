"""Cells on several devices: the trace reduced per device, and test-only
cells with `chips: 4` added to a copied checkout as new files and entries
(a sharded mauveAligner job, and sortContigs on a `drafts` traffic), run
on the CPU's logical shards and, marked `gpu`, on the cards present."""

import io
import json
import os
import shutil
from collections import defaultdict

import pytest

from benchmark import run, spec, trace

ROOT = spec.ROOT
M = 1_000_000  # ns a unit of the event lists below
# (name, is_device, start, end, device) in units of M ns; a job from 0 to 1000
ONE_DEVICE = [("phase:load", False, 0, 300), ("phase:anchoring", False, 300, 900),
              ("span:find_mums", False, 320, 880), ("phase:outputs", False, 900, 1000),
              ("k_a", True, 100, 200), ("k_b", True, 150, 250), ("k_a", True, 400, 500),
              ("k_c", True, 600, 650), ("copy", True, 950, 1200), ("aten::add", False, 10, 20)]
# what the reduction gave before it knew devices, on ONE_DEVICE
BEFORE = {"busy_s": 0.35, "window_s": 1.0,
          "device_ops": [("k_a", 0.2), ("k_b", 0.1), ("k_c", 0.05), ("copy", 0.05)],
          "idle_gaps": [("find_mums", 0.23), ("load", 0.1), ("find_mums", 0.1),
                        ("find_mums", 0.08), ("load", 0.05), ("outputs", 0.05),
                        ("anchoring", 0.02), ("anchoring", 0.02)]}
SHARDED_LENGTH = 30_000
DRAFTS_LENGTH = 1_000_000


def _events(rows, device=0):
    return [(n, d, s * M, e * M, device if d else -1) for n, d, s, e in rows]


def test_one_device_reduces_as_before():
    got = trace.reduce_events(_events(ONE_DEVICE), 0, 1000 * M)
    for key in ("busy_s", "window_s", "device_ops"):
        assert got[key] == BEFORE[key], key
    assert got["busy_s_by_device"] == [BEFORE["busy_s"]]
    # idle pieces are summed by span before they are ranked
    summed = defaultdict(float)
    for name, sec in BEFORE["idle_gaps"]:
        summed[name] += sec
    assert [name for name, _ in got["idle_gaps"]] == ["find_mums", "load", "outputs",
                                                      "anchoring"]
    assert dict(got["idle_gaps"]) == pytest.approx(dict(summed), abs=1e-12)


def test_two_devices_are_busy_apart_and_idle_together():
    rows = [("phase:anchoring", False, 0, 600, -1), ("phase:outputs", False, 600, 1000, -1),
            ("k", True, 100, 300, 0), ("k", True, 200, 500, 1), ("k", True, 250, 400, 1)]
    events = [(n, d, s * M, e * M, i) for n, d, s, e, i in rows]
    two = trace.reduce_events(events, 0, 1000 * M, chips=2)
    assert two["busy_s_by_device"] == [0.2, 0.3]
    assert two["busy_s"] == pytest.approx(0.25)
    assert two["device_ops"] == [("k", pytest.approx(0.65))]
    # no device works in [0, 100) and [500, 1000)
    assert dict(two["idle_gaps"]) == pytest.approx({"outputs": 0.4, "anchoring": 0.2})
    # a chip of the cell with no events counts as idle throughout
    four = trace.reduce_events(events, 0, 1000 * M, chips=4)
    assert four["busy_s_by_device"] == [0.2, 0.3, 0.0, 0.0]
    assert four["busy_s"] == pytest.approx(0.125)
    assert four["idle_gaps"] == two["idle_gaps"]


def _json(path):
    with open(os.path.join(ROOT, "benchmark", path)) as fh:
        return json.load(fh)


def _checkout(tmp_path, name, config, traffic, chips, work, traffic_data=None):
    """A copy of the benchmark with one more cell: only new files and a new
    BENCHMARK.json entry."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": chips, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {root / "benchmark" / "workloads" / f"{name}.json": work}
    if traffic_data is not None:
        new[root / "benchmark" / "traffic" / f"{traffic}.json"] = traffic_data
    for path, data in new.items():
        assert not path.exists()
        path.write_text(json.dumps(data))
    return str(root)


def _sharded_cell(tmp_path, chips):
    """mauveAligner on two genomes of the gapped traffic, its anchor search
    and DP batches over `chips` shards."""
    work = _json("workloads/pairwise_ecoli.gapped.json")
    assert work["command"][:2] == ["mauveAligner", "{inputs}"]
    work["command"] = ["mauveAligner", "{in0}", "{in1}", "--mesh-devices={chips}",
                       *work["command"][2:]]
    return _checkout(tmp_path, "pairwise_ecoli.sharded", "mauve_pairwise_ecoli", "gapped",
                     chips, work)


def _job_lines(err):
    lines = [json.loads(x) for x in err.getvalue().splitlines() if x.startswith("{")]
    warm = [x["warm_job"] for x in lines if "warm_job" in x]
    return warm + [x for x in lines if "job" in x]


def test_a_sharded_cell_runs_on_four_logical_shards(tmp_path):
    root = _sharded_cell(tmp_path, 4)
    err = io.StringIO()
    result = run.run("pairwise_ecoli.sharded", 2**31 + 13, 0.2, False, device="cpu",
                     genome_length=SHARDED_LENGTH, root=root, out=io.StringIO(), err=err)
    assert result["correct"] is True and result["failed"] == 0
    jobs = _job_lines(err)
    assert len(jobs) >= 2
    for job in jobs:
        counters = job.get("counters", job["work"])
        assert counters["k2_sharded_entries_per_device"] > 0


def test_a_four_chip_drafts_cell_needs_only_new_files(tmp_path):
    draft184 = _json("traffic/draft184.json")
    traffic = {"shape": "drafts", "why": "a test traffic: three drafts",
               "drafts": {**draft184["draft"], "count": 3}}
    work = _json("workloads/pairwise_ecoli.draft184.json")
    work.update(traffic="drafts3", command=["sortContigs", "{in0}", "{in1}",
                                            "--output={out}/sorted.fa"])
    root = _checkout(tmp_path, "pairwise_ecoli.drafts3", "mauve_pairwise_ecoli", "drafts3", 4,
                     work, traffic)
    result = run.run("pairwise_ecoli.drafts3", 2**32 + 29, 0.1, False, device="cpu",
                     genome_length=DRAFTS_LENGTH, root=root, out=io.StringIO(),
                     err=io.StringIO())
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) >= {"bad_contigs", "misplaced_share", "anchor_miss"}


@pytest.mark.gpu
def test_a_sharded_cell_synchronises_peaks_and_traces_every_card(cuda, tmp_path):
    import torch

    chips = min(torch.cuda.device_count(), 4)
    if chips < 2:
        pytest.skip("needs two NVIDIA GPUs or more")
    root = _sharded_cell(tmp_path, chips)
    result = run.run("pairwise_ecoli.sharded", 2**31 + 13, 1.0, True,
                     genome_length=SHARDED_LENGTH, root=root, out=io.StringIO(),
                     err=io.StringIO())
    device = result["device"]
    assert result["correct"] is True and device["count"] == chips
    assert len(device["memory_peak_bytes_by_device"]) == chips
    assert len(device["busy_s_by_device"]) == chips
    assert all(x > 0 for x in device["memory_peak_bytes_by_device"] + device["busy_s_by_device"])
    assert device["memory_peak_bytes"] == max(device["memory_peak_bytes_by_device"])
