"""Reducing one profiled job's torch.profiler trace to what the per-layer
metrics and the breakdown read.

Device activity is every CUDA event of the trace (kernels, copies, sets),
each on the device that ran it.  A device's busy time is the union of its
intervals, as the port uses one stream a device and a union never counts
overlap twice; `busy_s` is the mean over the cell's devices, so on several
devices the idle share it gives is the mean device's.  Idle gaps are the
stretches in which no device is busy.  Host spans are the profiler's user
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


def reduce_events(events, job_start_ns: int, job_end_ns: int, chips: int = 1) -> Dict:
    """events: (name, is_device, start_ns, end_ns, device_index) of the
    profiled job.  Returns busy seconds (the mean over `chips` devices and
    any other device with events; a device with none counts 0) and per
    device, the window's seconds, device seconds by operation name summed
    over devices, and the idle stretches when no device is busy, cut at the
    host spans' edges, each piece named by the innermost span open over it
    and summed by name."""
    device: Dict[int, List[Interval]] = defaultdict(list)
    spans = []
    by_op: Dict[str, float] = defaultdict(float)
    for name, is_device, s, e, index in events:
        if is_device:
            s, e = max(s, job_start_ns), min(e, job_end_ns)
            if e > s:
                device[index].append((s, e))
                by_op[name[:120]] += (e - s) / 1e9
        elif name.startswith(("phase:", "span:")):
            spans.append((name.split(":", 1)[1], s, e))
    indices = sorted(set(range(chips)) | set(device))
    busy_by_device = [sum(e - s for s, e in union(device[d])) / 1e9 for d in indices]
    busy = union([iv for ivs in device.values() for iv in ivs])
    edges = [job_start_ns] + [x for iv in busy for x in iv] + [job_end_ns]
    idle_ns: Dict[str, int] = defaultdict(int)
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        # cut the gap where a host span opens or closes; each piece is named
        # by the innermost span open over it (the one that opened last)
        cuts = sorted({s, e, *(t for sp in spans for t in sp[1:] if s < t < e)})
        for a, b in zip(cuts[:-1], cuts[1:]):
            open_spans = [sp for sp in spans if sp[1] <= a and b <= sp[2]]
            name = max(open_spans, key=lambda sp: sp[1])[0] if open_spans else "outside any phase"
            idle_ns[name] += b - a
    return {
        "busy_s": sum(busy_by_device) / len(busy_by_device),
        "busy_s_by_device": busy_by_device,
        "window_s": (job_end_ns - job_start_ns) / 1e9,
        "device_ops": sorted(by_op.items(), key=lambda x: -x[1]),
        "idle_gaps": sorted(((k, v / 1e9) for k, v in idle_ns.items()), key=lambda x: -x[1]),
    }


def kineto_events(prof) -> List[Tuple[str, bool, int, int, int]]:
    """(name, is_device, start_ns, end_ns, device_index) of every event of
    a finished torch.profiler.profile; the host's operator events are left
    out except the harness's annotations."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        is_device = ev.device_type() == DeviceType.CUDA
        name = ev.name()
        annotation = name.startswith(("phase:", "span:"))
        if is_device != annotation:  # device work, or a host span
            s = ev.start_ns()
            out.append((name, is_device, s, s + ev.duration_ns(), ev.device_index()))
    return out
