"""Run one cell of the port's benchmark for one seed.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's genomes from the seed, writes them as FASTA under
TMPDIR and runs one full job untimed, so every kernel is built and every
shape warm.  The window then runs full jobs back to back through the port's
own command line (mauvealigner_tpu_torch.tools.cli.main), a closed loop: a
user waits for each alignment before starting the next.  No job starts after
--seconds; the job in flight finishes and counts.  Every job has the same
inputs and must write the same bytes and do the same work as the warm job:
the same DP and HMM problems and cells, anchors and program counters.  Once
the window has closed, the plain reference (reference/<check>.py) judges the
files the last job wrote and what the warm job handed its launches.  On a
cell of several chips a job ends when each of its devices is synchronised,
and the peak memory is the fullest device's.

With --trace 1 the window's jobs also record host spans, and one more job
runs under torch.profiler; the per-layer metrics are read from both.

The last line of standard output is the result, one JSON object; the
numbers that decided `correct` are also the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's build caches stay inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", "benchmark_cache", _sub))
os.environ.setdefault("USE_FLAX", "0")

from benchmark import capture, spec  # noqa: E402
from benchmark.traffic import generate  # noqa: E402

# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "mauvealigner_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are forbidden, compared whole
    (mauvealigner_tpu_torch is not mauvealigner_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def expand(template, inputs, out_dir: str, chips: int = 1):
    """A command or output template with {inputs}, {in0}.., {out} and
    {chips} (the cell's device count)."""
    argv = []
    for word in template:
        if word == "{inputs}":
            argv.extend(inputs.files)
            continue
        word = word.replace("{out}", out_dir).replace("{chips}", str(chips))
        for k, path in enumerate(inputs.files):
            word = word.replace(f"{{in{k}}}", path)
        argv.append(word)
    return argv


def sha256_files(paths) -> dict:
    out = {}
    for name, path in paths.items():
        with open(path, "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


class Spans:
    """Host spans the harness records around calls into the program's
    layers during the traced run (benchmark instrumentation only)."""

    def __init__(self):
        self.seconds: dict = {}
        self.patches: list = []

    def wrap(self, owner, attr: str, name: str, annotate) -> None:
        inner = getattr(owner, attr)
        spans = self

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with annotate(f"span:{name}"):
                try:
                    return inner(*args, **kwargs)
                finally:
                    spans.seconds[name] = spans.seconds.get(name, 0.0) + time.perf_counter() - t0

        setattr(owner, attr, wrapped)
        self.patches.append((owner, attr, inner))

    def restore(self) -> None:
        for owner, attr, inner in reversed(self.patches):
            setattr(owner, attr, inner)
        self.patches.clear()


def annotated_phases(timing, annotate):
    """Make PhaseTimer.phase also open a profiler annotation, so the trace
    can name what the host was doing in each idle gap."""
    cls = timing.PhaseTimer
    inner = cls.phase

    @contextlib.contextmanager
    def phase(self, name):
        with annotate(f"phase:{name}"), inner(self, name):
            yield

    cls.phase = phase
    return lambda: setattr(cls, "phase", inner)


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        genome_length=None, root: str = spec.ROOT, out=sys.stdout, err=sys.stderr) -> dict:
    """Run the cell and return the result; print it last on `out`.
    device and genome_length are for tests on the CPU."""
    import torch

    from mauvealigner_tpu_torch.ops import gotoh_cuda
    from mauvealigner_tpu_torch.tools.cli import main as cli_main
    from mauvealigner_tpu_torch.utils import timing

    cell = spec.cell(workload, root)
    work = cell["workload"]
    chips = cell["chips"]
    on_cuda = device == "cuda"
    devices = range(chips if on_cuda else 0)  # the devices synchronised and peaked
    tmp = tempfile.mkdtemp(prefix="portbench-")
    shas: list = []  # the warm job's output first, then each timed job's
    try:
        inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], seed,
                                      os.path.join(tmp, "in"), genome_length)
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        argv = expand(work["command"], inputs, out_dir, chips) + [f"--device={device}"]
        outputs = dict(zip(work["outputs"],
                           expand(work["outputs"].values(), inputs, out_dir, chips)))
        stdout_path = outputs.get("stdout")

        def job() -> int:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(list(argv))
            for d in devices:
                torch.cuda.synchronize(d)
            if stdout_path:
                with open(stdout_path, "w") as fh:
                    fh.write(buf.getvalue())
            return rc

        def program_counters() -> dict:
            return {**timing.GLOBAL.counters,
                    **{f"launches.{k}": v for k, v in gotoh_cuda.LAUNCHES.items()}}

        recorders = work.get("capture", [])
        captured: dict = {}
        timing.GLOBAL.reset()
        gotoh_cuda.reset_launches()
        with capture.recording(recorders, captured):
            warm_rc = job()
        shas.append(sha256_files(outputs) if warm_rc == 0 else {})
        works = [capture.work_of(captured, program_counters())]  # the warm job's first
        setup_s = time.perf_counter() - T_START
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        spans = Spans()
        if trace:
            from mauvealigner_tpu_torch.models.aligner import MauveAligner

            spans.wrap(MauveAligner, "find_mums", "find_mums", contextlib.nullcontext)
        phases, counters = [], []
        counts: dict = {}

        def before():
            timing.GLOBAL.reset()
            spans.seconds = {}
            gotoh_cuda.reset_launches()
            counts.clear()

        def after(rc):
            phases.append({**timing.GLOBAL.phases,
                           **{f"span.{k}": v for k, v in spans.seconds.items()}})
            counters.append(program_counters())
            works.append(capture.work_of(counts, counters[-1]))
            shas.append(sha256_files(outputs) if rc == 0 else {})

        with capture.recording(recorders, counts, full=False):
            walls, rcs, window_s = timed_window(job, seconds, before, after)
        spans.restore()
        peaks = [torch.cuda.max_memory_allocated(d) for d in devices]
        profiled = None
        if trace:
            profiled = profile_job(job, torch, timing, gotoh_cuda, on_cuda, chips)
            rcs.append(profiled["rc"])
            shas.append(sha256_files(outputs) if profiled["rc"] == 0 else {})
        err.write(json.dumps({"warm_job": {"work": works[0], "sha256": shas[0]}}) + "\n")
        for k, (w, p, c, h) in enumerate(zip(walls, phases, counters, shas[1:])):
            err.write(json.dumps({"job": k, "wall_s": w, "phases": p, "counters": c,
                                  "work": works[k + 1], "sha256": h}) + "\n")
        ctx = {"cell": cell, "job_s": sum(walls) / len(walls), "setup_s": setup_s,
               "jobs": len(walls), "window_s": window_s, "phases": phases,
               "counters": counters, "peak_bytes": max(peaks, default=0), "trace": profiled}
        t_judge = time.perf_counter()
        if not (warm_rc == 0 and all(rc == 0 for rc in rcs)):
            checks, report = {"jobs_failed": [sum(rc != 0 for rc in rcs), 0]}, {}
        else:
            checks, report = judge(cell, inputs, outputs, device, shas, captured, works)
        report["reference_s"] = time.perf_counter() - t_judge
        ctx["report"] = report
        bad = forbidden_modules()
        if bad:
            err.write(f"forbidden modules loaded: {', '.join(bad)}\n")
            raise SystemExit(3)
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cell[kind]:
            value = spec.metric_reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        correct = all(v <= lim for v, lim in checks.values())
        result = {
            "correct": correct,
            "attempted": len(rcs),
            "failed": sum(rc != 0 for rc in rcs),
            "metrics": metrics,
            "device": device_info(torch, peaks, profiled),
        }
        if profiled:
            result["breakdown"] = {"device_ops": [list(x) for x in profiled["device_ops"][:10]],
                                   "idle_gaps": [list(x) for x in profiled["idle_gaps"][:10]]}
        result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
        err.write(json.dumps({"report": report}) + "\n")
        for k, (v, lim) in checks.items():
            err.write(f"check {k}: {v} (limit {lim}) {'ok' if v <= lim else 'FAILED'}\n")
        out.write(json.dumps(result) + "\n")
        out.flush()
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def timed_window(job, seconds: float, before=lambda: None, after=lambda rc: None):
    """Run job() back to back until `seconds` have passed since the first
    started; the job in flight when they pass finishes and counts.  Returns
    each job's wall (its start to its end; job() synchronises the devices),
    each return code, and the window's length.  before() and after(rc) run
    outside the jobs' walls."""
    walls, rcs = [], []
    t0 = time.perf_counter()
    while not walls or time.perf_counter() - t0 < seconds:
        before()
        tj = time.perf_counter()
        rc = job()
        walls.append(time.perf_counter() - tj)
        rcs.append(rc)
        after(rc)
    return walls, rcs, time.perf_counter() - t0


def judge(cell, inputs, outputs, device, shas, captured, works=None):
    """The numbers that decide `correct`, each with its limit: every job
    wrote the same bytes as the warm job and (where `works` is given, the
    warm job's first) did the same work, and the reference's judgement of
    the files the last job wrote and of what the warm job recorded."""
    limits = cell["workload"]["limits"]
    differing = sum(1 for h in shas[1:] if h != shas[0])
    numbers, report = spec.check_module(cell["workload"]["check"]).judge(
        inputs, outputs, captured, device)
    checks = {"jobs_differing": [differing, 0]}
    if works is not None:
        checks["jobs_work_differing"] = [sum(1 for w in works[1:] if w != works[0]), 0]
    for name, value in numbers.items():
        checks[name] = [value, limits[name]]
    return checks, report


def profile_job(job, torch, timing, gotoh_cuda, on_cuda, chips: int) -> dict:
    """One more job under torch.profiler, its spans annotated."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as trace_mod
    from mauvealigner_tpu_torch.models.aligner import MauveAligner

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    restore = annotated_phases(timing, record_function)
    spans = Spans()
    spans.wrap(MauveAligner, "find_mums", "find_mums", record_function)
    try:
        with profile(activities=activities) as prof:
            s = time.time_ns()
            rc = job()
            e = time.time_ns()
    finally:
        spans.restore()
        restore()
    # the profiler stamps its events with the wall clock in nanoseconds,
    # the clock the job's edges were read from
    reduced = trace_mod.reduce_events(trace_mod.kineto_events(prof), s, e, chips)
    reduced.update(rc=rc, launch_shapes=list(gotoh_cuda.LAUNCH_SHAPES))
    return reduced


def device_info(torch, peaks: list, profiled) -> dict:
    """peaks: each of the cell's devices' peak bytes (none on the CPU)."""
    if not peaks:
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(peaks),
                "memory_peak_bytes": int(max(peaks)),
                "memory_peak_bytes_by_device": [int(p) for p in peaks]}
    if profiled:
        info["busy_s"] = profiled["busy_s"]
        info["window_s"] = profiled["window_s"]
        info["busy_s_by_device"] = profiled["busy_s_by_device"]
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    chips = spec.cell(a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"run.py: the cell needs {chips} CUDA device(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    run(a.workload, a.seed, a.seconds, bool(a.trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
