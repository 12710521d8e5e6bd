"""Where a progressive run's time goes on the GPU, for the PyTorch port.

Builds config 3 (9 x 250 kbp, scripts/bench_configs.py) or the 9 x 1 Mbp
enterobacteria-like genomes of the tree-progressive branch, runs
ProgressiveMauve on cuda:0 once to warm up (kernel build, allocator), then
once under torch.profiler (CUDA activity).  Prints the per-phase host
report, the kernels by device time, one line per Gotoh kernel (launches and
device ms) and the device busy and idle shares of the profiled run, with
the card's name and power limit.

Usage:  python scripts/profile_port_progressive.py [3|tree] [--trace PATH] [--root DIR]

`--root DIR` imports the port's package from DIR (another checkout, for
example the parent commit unpacked into a git-ignored directory), so two
versions run the same configuration in turns, one process each.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

GOTOH_KERNELS = ("gotoh_forward_codes_kernel", "gotoh_forward_profiles_kernel",
                 "gotoh_traceback_kernel")


def genomes_of(config: str):
    from mauvealigner_tpu_torch.utils import simulate

    if config == "tree":
        return simulate.enterobacteria_like(1_000_000, 9, 0.08)[0]
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 250_000)
    out = [anc]
    for _ in range(8):
        out.append(simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)[0])
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default="3", choices=["3", "tree"])
    p.add_argument("--trace", default="")
    p.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        print("profile_port_progressive: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    genomes = genomes_of(a.config)
    pm = ProgressiveMauve(ProgressiveOptions(device="cuda"))
    pm.align(genomes)  # warm-up
    torch.cuda.synchronize()
    timing.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pm.align(genomes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(timing.GLOBAL.report().rstrip())
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=30))
    label = os.path.basename(os.path.abspath(a.root))
    for name in GOTOH_KERNELS:
        rows = [e for e in events if name in e.key and e.device_type == DeviceType.CUDA]
        print(f"[{label}] config {a.config} {name}: {sum(e.count for e in rows)} launches, "
              f"{sum(e.self_device_time_total for e in rows) / 1e3:.3f} ms ({card})")
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    print(f"config {a.config} profiled run: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s, device idle share {1 - busy_us / 1e6 / wall:.4f} ({card})")
    if a.trace:
        os.makedirs(os.path.dirname(os.path.abspath(a.trace)), exist_ok=True)
        prof.export_chrome_trace(a.trace)
        print(f"trace: {a.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
