"""sortContigs over several drafts (BASELINE config 5's front half) on the
CPU under make_mesh(4, "cpu"): the benchmark's cell `drafts20_sharded.4chip`
judged correct at 500 kbp, the same bytes from the mesh route, the
sequential route and one-draft runs, a one-draft run's bytes as they were
before several drafts were taken, the sharded pair search's spans and
counters, and the `placement` fault and the `sketch` control judged not
correct; on the card, the sharded search against the one-device search."""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import capture, control, spec
from benchmark.traffic import generate
from mauvealigner_tpu_torch.tools.cli import main as cli
from mauvealigner_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "drafts20_sharded.4chip"
LENGTH = 500_000  # 184 contigs of about 2.7 kbp: 7-8% misplaced against a limit of 15%
SEED = 2**32 + 41
SMALL = {"genome_length": 150_000}
THREE = {"shape": "drafts", "drafts": {"sub": 0.01, "indel": 0.0005, "contigs": 12,
                                       "revcomp": 0.4, "count": 3}}
ONE = {"shape": "draft", "draft": {"sub": 0.01, "indel": 0.0005, "contigs": 12, "revcomp": 0.4}}
# sha256 of the reordered draft and of the printed log of `sortContigs ref draft` on ONE's
# inputs at SMALL's length and seed 2**34 + 3, as sortContigs wrote them when it took one
# draft only
ONE_DRAFT_SHA256 = ("5c5de31850d81cfdd696287e19673f90cf7d9ba5adadb6da9ba54e11659ed8ab",
                    "0ce09eabec07219044eac86a73a0e93c870bd4586011272beef0e691048f9e36")
TOP = ["load", "anchoring", "lcb_determination", "placement", "outputs"]
PAIR_SPANS = ("pair_sml", "pair_scatter", "pair_tables", "k2_extend")
PAIR_COUNTERS = ("pair_search_pairs", "pair_entries_per_device", "pair_cap_retries",
                 "k2_extend_rows")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _job(argv, recorders=()):
    """One sortContigs job on the CPU: (standard output, what the recorders
    saw, span calls, counters)."""
    captured: dict = {}
    buf = io.StringIO()
    timing.GLOBAL.reset()
    with contextlib.redirect_stdout(buf), capture.recording(recorders, captured):
        assert cli(list(argv) + ["--device=cpu"]) == 0
    return buf.getvalue(), captured, dict(timing.GLOBAL.calls), dict(timing.GLOBAL.counters)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """A reference and three 12-contig drafts of 150 kbp."""
    d = tmp_path_factory.mktemp("three")
    return generate.make_inputs(SMALL, THREE, 2**33 + 11, str(d / "in")), d


def _route(inputs, out, *extra):
    return _job(["sortContigs", *inputs.files, f"--output-dir={out}", *extra])


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
    assert {"job_s", "setup_s", "contigs_in_place"} <= set(result["metrics"])
    assert result["checks"]["drafts_missing"]["value"] == 0
    assert result["metrics"]["contigs_in_place"]["value"] > 0.85


def test_every_route_writes_the_same_bytes(three):
    inputs, d = three
    mesh_out, _, _, _ = _route(inputs, d / "mesh", "--mesh-devices=4")
    seq_out, _, _, _ = _route(inputs, d / "seq")
    assert mesh_out == seq_out
    blocks = []
    for k, path in enumerate(inputs.files[1:]):
        one_out, _, _, _ = _job(["sortContigs", inputs.files[0], path,
                                 f"--output={d}/one{k}.fa"])
        written = (d / f"one{k}.fa").read_bytes()
        name = os.path.basename(path)
        assert (d / "mesh" / name).read_bytes() == written
        assert (d / "seq" / name).read_bytes() == written
        assert len(one_out.splitlines()) == 12
        blocks.append(f"{path}\n{one_out}")
    assert mesh_out == "".join(blocks)


@pytest.mark.parametrize("extra", [[], ["--mesh-devices=4"]])
def test_a_one_draft_run_writes_what_it_wrote_before(tmp_path, extra):
    inputs = generate.make_inputs(SMALL, ONE, 2**34 + 3, str(tmp_path / "in"))
    out, _, _, _ = _job(["sortContigs", *inputs.files, f"--output={tmp_path}/o.fa", *extra])
    assert (_sha((tmp_path / "o.fa").read_bytes()), _sha(out.encode())) == ONE_DRAFT_SHA256


def test_several_drafts_refuse_one_output_file(three):
    inputs, d = three
    with pytest.raises(SystemExit):
        cli(["sortContigs", *inputs.files, f"--output={d}/x.fa", "--device=cpu"])


def _longest_pair(inputs) -> int:
    """The most mer-list entries of a (reference, draft) pair, under the
    seed every pair of `inputs` searches with."""
    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
    from mauvealigner_tpu_torch.tools.common import load_genome

    ref, *drafts = [load_genome(f) for f in inputs.files]
    weights = {default_mer_size(int(np.mean([len(ref), len(d)]))) for d in drafts}
    assert len(weights) == 1
    seed = get_seed(weights.pop(), 0)
    n_ref = int(build_mer_list_device(ref, seed, "cpu")[0].shape[0])
    return max(n_ref + int(build_mer_list_device(d, seed, "cpu")[0].shape[0]) for d in drafts)


def test_the_sharded_spans_and_counters_repeat_exactly(three):
    inputs, d = three
    runs = [_route(inputs, d / f"spans{k}", "--mesh-devices=4") for k in range(2)]
    (_, _, calls, counters), (_, _, calls2, counters2) = runs
    assert [p for p in calls if "/" not in p] == TOP
    for name in PAIR_SPANS:
        assert calls[f"anchoring/{name}"] == 1, name
    # one placement pass per draft
    assert calls["lcb_determination"] == calls["placement"] == 3
    assert calls == calls2
    for name in PAIR_COUNTERS:
        assert name in counters and counters[name] == counters2[name], name
    assert counters["pair_search_pairs"] == 3 and counters["pair_cap_retries"] == 0
    assert counters["k2_extend_rows"] > 0
    # four shards of one pair row each (three drafts and a padding row),
    # every row padded to the longest pair's entries
    assert counters["pair_entries_per_device"] == _longest_pair(inputs)
    # the sequential route counts the same extension rows
    _, _, seq_calls, seq_counters = _route(inputs, d / "spans_seq")
    assert [p for p in seq_calls if "/" not in p] == TOP
    assert seq_counters["k2_extend_rows"] == counters["k2_extend_rows"]


@pytest.fixture(scope="module")
def cell_inputs(tmp_path_factory):
    cell = spec.cell(CELL)
    tmp = str(tmp_path_factory.mktemp("cell"))
    inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], SEED,
                                  os.path.join(tmp, "in"), LENGTH)
    return cell, inputs, tmp


@pytest.mark.parametrize("kind,failing", [("placement", "misplaced_share"),
                                          ("sketch", "anchor_miss")])
def test_a_broken_job_is_not_correct(cell_inputs, kind, failing):
    cell, inputs, tmp = cell_inputs
    ctx = control.sketch() if kind == "sketch" else control.fault(kind)
    with ctx:
        judged = control.judged_job(cell, inputs, tmp, "cpu")
    assert judged["rc"] == 0 and judged["correct"] is False
    assert judged["checks"][failing] > judged["limits"][failing]
    assert judged["checks"]["bad_contigs"] == judged["checks"]["drafts_missing"] == 0


@pytest.mark.gpu
def test_the_sharded_search_on_the_cards_equals_the_one_device_search(tmp_path):
    """Each card extends its own pairs (the kernel, not the host loop) and
    every pair's rows equal find_multi_mums_device's on one card."""
    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.ops import matchops
    from mauvealigner_tpu_torch.parallel import find_pair_mums_sharded, make_mesh
    from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
    from mauvealigner_tpu_torch.tools.common import load_genome

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs or more")
    n = min(torch.cuda.device_count(), 4)
    traffic = {"shape": "drafts", "drafts": {**THREE["drafts"], "count": n + 1}}
    inputs = generate.make_inputs({"genome_length": 300_000}, traffic, 2**33 + 29,
                                  str(tmp_path))
    ref, *drafts = [load_genome(f) for f in inputs.files]
    seed = get_seed(default_mer_size(len(ref)), 0)
    timing.GLOBAL.reset()
    got = find_pair_mums_sharded(ref, drafts, seed, make_mesh(n, "cuda"))
    counters = dict(timing.GLOBAL.counters)
    assert counters["k2_extend_rows_device"] == counters["k2_extend_rows"] > 0
    dev = torch.device("cuda", 0)
    for d, ml in zip(drafts, got):
        want = matchops.find_multi_mums_device(
            [ref, d], [build_mer_list_device(g, seed, dev) for g in (ref, d)],
            seed_length=seed.length)
        assert len(ml) > 0
        assert np.array_equal(ml.starts, want.starts)
        assert np.array_equal(ml.lengths, want.lengths)
