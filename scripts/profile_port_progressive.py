"""Where a progressive run's time goes on the GPU, for the PyTorch port.

Builds config 3 (9 x 250 kbp, scripts/bench_configs.py; 3bacterial: 9 x
4.6 Mbp, uncut, through the extant branch as --tree-progressive=0 runs it,
utils/digest.BACTERIAL_RECIPES), the 9 x 1 Mbp
enterobacteria-like genomes of the tree-progressive branch (--size sets
their length: 4600000 gives BASELINE.md's headline, the genomes of
scripts/bench_enterobacteria.py), or config 5's
draft workflow (a 150 kbp reference and 7 drafts of 6 contigs; 5wide: a
500 kbp reference and 20 drafts of 20 contigs; 5bacterial: a 4.6 Mbp
reference and 20 drafts of 184 contigs, uncut, whose genomes take about
two minutes to build), runs it on cuda:0 once to
warm up (kernel build, allocator), then once under torch.profiler (CUDA
activity): ProgressiveMauve, for config 5 after the per-draft anchor search
and sortContigs (utils/digest.sort_drafts).  Prints the per-phase host
report (of the progressive run), the kernels by device time, one line per
Gotoh kernel (launches and device ms) and the device busy and idle shares
of the profiled run, with the card's name and power limit.

Usage:  python scripts/profile_port_progressive.py [3|3bacterial|tree|5|5wide|5bacterial] [--size N]
            [--trace PATH] [--root DIR]

`--root DIR` imports the port's package from DIR (another checkout, for
example the parent commit unpacked into a git-ignored directory), so two
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
# the draft workflows (utils/digest.DRAFT_SHAPES)
DRAFTS = ("5", "5wide", "5bacterial")


def genomes_of(config: str, size: int):
    from mauvealigner_tpu_torch.utils import digest, simulate

    if config == "tree":
        return simulate.enterobacteria_like(size, 9, 0.08)[0]
    if config == "3bacterial":
        return digest.bacterial_genomes("config3_extant_bacterial", simulate)
    return digest.config3_genomes(simulate)


def workload(config: str, size: int):
    """A callable that runs the configuration once on cuda."""
    from mauvealigner_tpu_torch.models import aligner
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.tools import manipulate
    from mauvealigner_tpu_torch.utils import digest, simulate, timing

    if config in DRAFTS:
        ref, drafts = simulate.draft_genomes(*digest.DRAFT_SHAPES[config])
        pm = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False, device="cuda"))

        def run():
            reordered, _ = digest.sort_drafts(ref, drafts, aligner, manipulate, device="cuda")
            timing.GLOBAL.reset()
            pm.align([ref] + reordered)
        return run
    genomes = genomes_of(config, size)
    # 3bacterial: the extant branch, which the default gate does not take
    # at this size
    pm = ProgressiveMauve(ProgressiveOptions(
        device="cuda", **({"tree_progressive": False} if config == "3bacterial" else {})))
    return lambda: pm.align(genomes)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default="3", choices=["3", "3bacterial", "tree", *DRAFTS])
    p.add_argument("--size", type=int, default=1_000_000,
                   help="genome length of the tree configuration")
    p.add_argument("--trace", default="")
    p.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    from mauvealigner_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        print("profile_port_progressive: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    run = workload(a.config, a.size)
    run()  # warm-up
    torch.cuda.synchronize()
    timing.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
