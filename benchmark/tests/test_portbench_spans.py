"""The readers of the program's span tree: extend_s, xmfa_s and
unspanned_s, on made-up window jobs and on a traced CPU run of cell 1."""

import io

import pytest

from benchmark import run, spec


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def ctx_of(phases, job_s=10.0):
    return {"phases": phases, "job_s": job_s}


JOBS = [
    {"load": 0.5, "anchoring": 2.0, "anchoring/k2_extend": 0.75,
     "tree_progressive": 4.0, "tree_progressive/pool/pair_align/anchoring/k2_extend": 0.25,
     "outputs": 3.0, "outputs/xmfa": 2.5, "span.find_mums": 1.9},
    {"load": 0.5, "anchoring": 2.0, "anchoring/k2_extend": 1.25,
     "tree_progressive": 4.0, "outputs": 2.5, "outputs/xmfa": 1.5, "span.find_mums": 1.9},
]


def test_extend_s_sums_k2_extend_at_every_depth():
    assert read("extend_s", ctx_of(JOBS)) == pytest.approx((0.75 + 0.25 + 1.25) / 2)
    # a span whose name only ends in the letters is another span
    assert read("extend_s", ctx_of([{"anchoring/rk2_extend": 1.0}])) is None


def test_xmfa_s_reads_the_xmfa_writer_under_outputs():
    assert read("xmfa_s", ctx_of(JOBS)) == pytest.approx(2.0)
    assert read("xmfa_s", ctx_of([{"xmfa": 1.0, "outputs": 1.0}])) is None


def test_unspanned_s_is_the_wall_less_the_top_level_spans():
    # top-level: load, anchoring, tree_progressive, outputs; span.* and
    # children left out
    assert read("unspanned_s", ctx_of(JOBS)) == pytest.approx(10.0 - (9.5 + 9.0) / 2)


@pytest.mark.parametrize("name", ["extend_s", "xmfa_s", "unspanned_s"])
def test_a_program_without_the_spans_reads_nothing(name):
    """The parent's window jobs hold the harness's span only (cell 3), or
    no jobs at all."""
    assert read(name, ctx_of([{"span.find_mums": 1.0}] * 3)) is None
    assert read(name, ctx_of([])) is None


def test_a_traced_cpu_run_of_cell_1_reports_the_span_metrics():
    out = io.StringIO()
    result = run.run("pairwise_ecoli.gapped", 2**31 + 23, 0.2, True, device="cpu",
                     genome_length=30_000, out=out, err=io.StringIO())
    assert result["correct"]
    metrics = result["metrics"]
    assert {"extend_s", "xmfa_s", "unspanned_s"} <= set(metrics)
    assert 0 < metrics["extend_s"]["value"] < metrics["anchor_s"]["value"]
    assert 0 < metrics["xmfa_s"]["value"] < metrics["output_s"]["value"]
    assert metrics["unspanned_s"]["unit"] == "s"
    # the profiled job's idle stretches are named by the program's span paths
    assert any("/" in name for name, _ in result["breakdown"]["idle_gaps"])
