"""Where a repeatoire run's time goes on the GPU, for the PyTorch port.

Builds BASELINE config 4 (the 236 kbp planted-family genome of
scripts/bench_configs.py config4, utils/simulate.planted_repeats) or its
bacterial-scale variant (every spacer 4x, 926 kbp; --spacer-scale sets
the factor: 20 gives a whole 4,606,000 bp chromosome), runs
Repeatoire.find_repeats with default options on cuda:0 once to warm up
(kernel build, allocator), then once under torch.profiler (CUDA activity).
Prints the per-phase host report, the kernels by device time, one line per
Gotoh kernel (launches and device ms) and the device busy and idle shares of
the profiled run, with the card's name and power limit.

Usage:  python scripts/profile_port_repeatoire.py [4|4big] [--spacer-scale N] [--trace PATH]
            [--root DIR]

`--root DIR` imports the port's package from DIR (another checkout), so two
versions run the same configuration in turns, one process each.
"""

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

GOTOH_KERNELS = ("gotoh_forward_codes_kernel", "gotoh_forward_profiles_kernel",
                 "gotoh_traceback_kernel")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default="4", choices=["4", "4big"])
    p.add_argument("--spacer-scale", type=int, default=0,
                   help="multiply every spacer by N (4big: 4, 4: 1)")
    p.add_argument("--trace", default="")
    p.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    from mauvealigner_tpu_torch.models.repeatoire import Repeatoire, RepeatoireOptions
    from mauvealigner_tpu_torch.utils import simulate, timing

    if not torch.cuda.is_available():
        print("profile_port_repeatoire: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    genome = simulate.planted_repeats(a.spacer_scale or (4 if a.config == "4big" else 1))
    rp = Repeatoire(RepeatoireOptions(device="cuda"))
    rp.find_repeats(genome)  # warm-up
    torch.cuda.synchronize()
    timing.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fams = rp.find_repeats(genome)
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
    print(f"config {a.config} profiled run: {len(fams)} families, wall {wall:.3f} s, device "
          f"busy {busy_us / 1e6:.3f} s, device idle share {1 - busy_us / 1e6 / wall:.4f} ({card})")
    if a.trace:
        os.makedirs(os.path.dirname(os.path.abspath(a.trace)), exist_ok=True)
        prof.export_chrome_trace(a.trace)
        print(f"trace: {a.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
