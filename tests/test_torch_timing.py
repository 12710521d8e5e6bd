"""The port's span tree (utils/timing.py): span paths and self time, the
top-level spans each benchmarked command records, spans from the ladder's
pool workers, and the profiler ranges the spans open only while a torch
profiler records."""

import os
import time

import numpy as np
import pytest
import torch

from mauvealigner_tpu_torch.genome import write_fasta
from mauvealigner_tpu_torch.tools.cli import main as cli
from mauvealigner_tpu_torch.utils import simulate, timing

# the top-level spans of one job of each command before the span tree, and
# those it adds
PARENT_TOP = {
    "mauveAligner": ["anchoring", "lcb_determination", "lcb_extension",
                     "recursive_anchoring", "gapped_closure", "outputs"],
    "progressiveMauve": ["anchoring", "guide_tree", "tree_progressive", "refinement",
                         "homology_backbone"],
    "sortContigs": [],
}
NEW_TOP = {
    "mauveAligner": ["load"],
    "progressiveMauve": ["load", "distance", "unaligned", "outputs"],
    "sortContigs": ["load", "anchoring", "lcb_determination", "placement", "outputs"],
}
TOP = {
    "mauveAligner": ["load", *PARENT_TOP["mauveAligner"]],
    "progressiveMauve": ["load", "anchoring", "distance", "guide_tree", "tree_progressive",
                         "refinement", "unaligned", "homology_backbone", "outputs"],
    "sortContigs": NEW_TOP["sortContigs"],
}


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_paths_self_time_and_calls_on_a_synthetic_nest(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    t = timing.PhaseTimer()
    with t.phase("a"):
        clock.now += 1.0
        for _ in range(2):
            with t.phase("b"):
                clock.now += 2.0
                with t.phase("c"):
                    clock.now += 0.5
        with t.phase("c"):
            clock.now += 4.0
    with t.phase("b"):
        clock.now += 8.0
    t.add("dp_cells", 3)
    assert list(t.phases) == ["a", "a/b", "a/b/c", "a/c", "b"]
    assert t.phases == {"a": 10.0, "a/b": 5.0, "a/b/c": 1.0, "a/c": 4.0, "b": 8.0}
    assert t.calls == {"a": 1, "a/b": 2, "a/b/c": 2, "a/c": 1, "b": 1}
    assert t.self_seconds("a") == 1.0
    assert t.self_seconds("a/b") == 4.0
    assert t.self_seconds("a/b/c") == 1.0
    assert t.path() == ()
    report = t.report()
    rows = [line.split() for line in report.splitlines()[1:6]]
    assert rows == [["a", "10.000", "1.000", "1"], ["a/b", "5.000", "4.000", "2"],
                    ["a/b/c", "1.000", "1.000", "2"], ["a/c", "4.000", "4.000", "1"],
                    ["b", "8.000", "8.000", "1"]]
    assert "dp_cells: 3" in report
    # a span that raises still closes, and under() nests another thread's spans
    with pytest.raises(ValueError), t.phase("x"):
        raise ValueError
    assert t.path() == () and t.calls["x"] == 1
    with t.under(("a", "b")):
        with t.phase("w"):
            assert t.path() == ("a", "b", "w")
    assert "a/b/w" in t.phases and t.path() == ()
    t.reset()
    assert not t.phases and not t.calls and not t.counters


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Small FASTA inputs for each command: two 40 kbp genomes at 1%, five
    8 kbp genomes at 6% and a 60 kbp reference with a six-contig draft."""
    d = tmp_path_factory.mktemp("timing")
    rng = np.random.default_rng(17)
    anc = simulate.random_genome(rng, 40_000)
    pair = [anc, simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005,
                                 del_rate=0.0005)[0]]
    anc = simulate.random_genome(rng, 8_000)
    five = [simulate.evolve(anc, rng, sub_rate=0.06, ins_rate=0.002, del_rate=0.002)[0]
            for _ in range(5)]
    ref, drafts = simulate.draft_genomes(60_000, 2, 6)

    def files(name, genomes):
        paths = []
        for k, g in enumerate(genomes):
            paths.append(str(d / f"{name}{k}.fa"))
            write_fasta(g, paths[-1])
        return paths

    out = str(d / "out")
    os.makedirs(out)
    return {
        "mauveAligner": ["mauveAligner", *files("p", pair), f"--output={out}/m.mln",
                         f"--output-alignment={out}/m.xmfa", "--backbone-size=50",
                         f"--backbone-output={out}/m.backbone", "--island-size=50",
                         f"--island-output={out}/m.islands"],
        "progressiveMauve": ["progressiveMauve", "--tree-progressive=1", "--disable-cache",
                             "--seed-weight=9", f"--output={out}/t.xmfa", *files("t", five)],
        "sortContigs": ["sortContigs", *files("d", [ref, drafts[0]]),
                        f"--output={out}/sorted.fa"],
    }


def _job(argv, capsys):
    timing.GLOBAL.reset()
    t0 = time.perf_counter()
    assert cli(argv + ["--device=cpu"]) == 0
    wall = time.perf_counter() - t0
    capsys.readouterr()
    return wall


@pytest.mark.parametrize("command", sorted(TOP))
def test_a_job_records_its_top_level_spans_and_little_outside_them(inputs, command, capsys):
    """The parent's top-level spans and the new ones, in the order they
    open; counters hold counts only; and a warm job leaves under
    max(2%, 20 ms) of its wall outside every top-level span."""
    assert sorted(TOP[command]) == sorted(PARENT_TOP[command] + NEW_TOP[command])
    _job(inputs[command], capsys)  # warm: the command's lazy imports
    wall = _job(inputs[command], capsys)
    top = {k: t for k, t in timing.GLOBAL.phases.items() if "/" not in k}
    assert list(top) == TOP[command]
    assert not [c for c in timing.GLOBAL.counters if c.endswith("_s")]
    assert wall - sum(top.values()) < max(0.02 * wall, 0.020)
    if command != "sortContigs":
        assert "outputs/xmfa" in timing.GLOBAL.phases
    assert any(k.endswith("k2_extend") for k in timing.GLOBAL.phases)


def test_ladder_workers_nest_their_spans_under_tree_progressive(inputs, capsys, monkeypatch):
    monkeypatch.setenv("MAUVE_TP_WORKERS", "4")
    _job(inputs["progressiveMauve"], capsys)
    phases, calls = timing.GLOBAL.phases, timing.GLOBAL.calls
    assert calls["tree_progressive/pool"] == 1
    # five genomes: four node merges, each one task of the pool
    assert calls["tree_progressive/pool/pair_align"] == 4
    assert calls["tree_progressive/pool/pair_align/anchoring"] == 4
    for name in ("pair_align", "unaligned", "compose", "consensus"):
        assert [k for k in phases if "/" in k and k.split("/")[-1] == name] == [
            f"tree_progressive/pool/{name}"]
    assert list(k for k in phases if "/" not in k) == TOP["progressiveMauve"]


def test_no_profiler_range_opens_while_no_profiler_records(inputs, capsys, monkeypatch):
    opened = []
    inner = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return inner(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _job(inputs["mauveAligner"], capsys)
    assert opened == []
    assert timing.GLOBAL.calls["outputs/xmfa"] == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.GLOBAL.phase("probe"), timing.GLOBAL.phase("inner"):
            pass
    assert opened == ["phase:probe", "phase:probe/inner"]


def test_profiler_ranges_name_each_span_by_path_inside_its_parent(inputs, capsys):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _job(inputs["mauveAligner"], capsys)
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("phase:"):
            s = ev.start_ns()
            ranges.setdefault(ev.name()[len("phase:"):], []).append((s, s + ev.duration_ns()))
    for child, parent in (("outputs/xmfa", "outputs"), ("anchoring/k2_extend", "anchoring")):
        assert ranges[child]
        for s, e in ranges[child]:
            assert any(ps <= s and e <= pe for ps, pe in ranges[parent]), child
    assert set(ranges) == set(timing.GLOBAL.phases)
