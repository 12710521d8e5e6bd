"""Where config 1's time goes on the GPU, for the PyTorch port.

Runs bench.py's config 1 (two 1 Mbp genomes about 1% apart, seed 37)
through mauvealigner_tpu_torch's MauveAligner on cuda:0: one warm-up run,
then one run under torch.profiler (CPU + CUDA activities).  Prints the
per-phase host report, the kernels by device time, and the device busy and
idle shares of the profiled run; writes the Chrome trace to --trace.

Usage:  python scripts/profile_port_config1.py [--trace build/config1_trace.json]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner  # noqa: E402
from mauvealigner_tpu_torch.utils import simulate, timing  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default="build/config1_trace.json")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_config1: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 1_000_000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    aligner = MauveAligner(AlignerOptions(use_sml_cache=False, device="cuda"))
    aligner.align([anc, der])  # warm-up: kernel build, allocator, caches
    torch.cuda.synchronize()
    timing.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        aligner.align([anc, der])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(timing.GLOBAL.report().rstrip())
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    # kernel and copy rows only: an operator's row repeats its kernels' time
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    print(f"profiled run: wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"device idle share {1 - busy_us / 1e6 / wall:.4f} ({card})")
    os.makedirs(os.path.dirname(os.path.abspath(a.trace)), exist_ok=True)
    prof.export_chrome_trace(a.trace)
    print(f"trace: {a.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
