"""Reducing one profiled job's torch.profiler trace to what the per-layer
metrics and the breakdown read.

Device activity is every CUDA event of the trace (kernels, copies, sets);
busy time is the union of their intervals, as the port uses one stream and
a union never counts overlap twice.  Host spans are the profiler's user
annotations that the harness opened (``phase:<name>``, ``span:<name>``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[int, int]


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events, job_start_ns: int, job_end_ns: int) -> Dict:
    """events: (name, is_device, start_ns, end_ns) of the profiled job.
    Returns busy and window seconds, device seconds by operation name, and
    the idle stretches between device activity, cut at the host spans'
    edges and each named by the innermost span open over it."""
    device, spans = [], []
    by_op: Dict[str, float] = defaultdict(float)
    for name, is_device, s, e in events:
        if is_device:
            s, e = max(s, job_start_ns), min(e, job_end_ns)
            if e > s:
                device.append((s, e))
                by_op[name[:120]] += (e - s) / 1e9
        elif name.startswith(("phase:", "span:")):
            spans.append((name.split(":", 1)[1], s, e))
    busy = union(device)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    edges = [job_start_ns] + [x for iv in busy for x in iv] + [job_end_ns]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    named = []
    for s, e in gaps:
        # cut the gap where a host span opens or closes; each piece is named
        # by the innermost span open over it (the one that opened last)
        cuts = sorted({s, e, *(t for sp in spans for t in sp[1:] if s < t < e)})
        for a, b in zip(cuts[:-1], cuts[1:]):
            open_spans = [sp for sp in spans if sp[1] <= a and b <= sp[2]]
            name = max(open_spans, key=lambda sp: sp[1])[0] if open_spans else "outside any phase"
            if named and named[-1][0] == name and named[-1][2] == a:
                named[-1] = (name, named[-1][1] + (b - a) / 1e9, b)
            else:
                named.append((name, (b - a) / 1e9, b))
    named = [(name, sec) for name, sec, _ in named]
    named.sort(key=lambda x: -x[1])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (job_end_ns - job_start_ns) / 1e9,
        "device_ops": sorted(by_op.items(), key=lambda x: -x[1]),
        "idle_gaps": named,
    }


def kineto_events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, is_device, start_ns, end_ns) of every event of a finished
    torch.profiler.profile; the host's operator events are left out except
    the harness's annotations."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        is_device = ev.device_type() == DeviceType.CUDA
        name = ev.name()
        annotation = name.startswith(("phase:", "span:"))
        if is_device != annotation:  # device work, or a host span
            s = ev.start_ns()
            out.append((name, is_device, s, s + ev.duration_ns()))
    return out
