"""Where a mauveAligner run's time goes on the GPU, for the PyTorch port.

Config 1 (bench.py: two 1 Mbp genomes about 1% apart, seed 37) runs
through mauvealigner_tpu_torch's MauveAligner; config 2 (BASELINE config 2,
scripts/bench_configs.py: three 500 kbp genomes, one inverted stretch)
through the port's mauveAligner command line with islands and backbone at
50 (utils/digest.CONFIG2_ARGS), in a temporary directory.  1bacterial and
2bacterial run the same at E. coli length, uncut (4.6 Mbp genomes,
utils/digest.BACTERIAL_RECIPES).  Each runs on
cuda:0 once to warm up (kernel build, allocator, caches), then once under
torch.profiler (CPU + CUDA activities).  Prints the per-phase host report,
the kernels by device time, one line per Gotoh kernel (launches and device
ms), and the device busy and idle shares of the profiled run with the
card's name and power limit; writes the Chrome trace to --trace.

Usage:  python scripts/profile_port_config1.py [1|2|1bacterial|2bacterial]
            [--trace build/config1_trace.json]
"""

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner  # noqa: E402
from mauvealigner_tpu_torch.tools.cli import main as port_cli  # noqa: E402
from mauvealigner_tpu_torch.utils import digest, simulate, timing  # noqa: E402

GOTOH_KERNELS = ("gotoh_forward_codes_kernel", "gotoh_forward_profiles_kernel",
                 "gotoh_traceback_kernel")


def config1_run(genomes):
    aligner = MauveAligner(AlignerOptions(use_sml_cache=False, device="cuda"))
    return lambda: aligner.align(genomes)


@contextlib.contextmanager
def config2_run(genomes):
    with tempfile.TemporaryDirectory() as d:
        digest.write_fasta_files(genomes, d, digest.CONFIG2_SEQS)
        with contextlib.chdir(d):
            yield lambda: port_cli(["mauveAligner", *digest.CONFIG2_ARGS, "--device=cuda"])


def workload(config: str):
    """A context giving a callable that runs the configuration once."""
    if config == "1":
        return contextlib.nullcontext(config1_run(digest.config1_genomes(simulate)))
    if config == "2":
        return config2_run(digest.config2_genomes(simulate))
    genomes = digest.bacterial_genomes(f"config{config[0]}_bacterial", simulate)
    if config == "1bacterial":
        return contextlib.nullcontext(config1_run(genomes))
    return config2_run(genomes)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default="1",
                   choices=["1", "2", "1bacterial", "2bacterial"])
    p.add_argument("--trace", default="")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_config1: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    trace = a.trace or f"build/config{a.config}_trace.json"
    with workload(a.config) as run:
        run()  # warm-up
        torch.cuda.synchronize()
        timing.GLOBAL.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    print(timing.GLOBAL.report().rstrip())
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    for name in GOTOH_KERNELS:
        rows = [e for e in events if name in e.key and e.device_type == DeviceType.CUDA]
        print(f"config {a.config} {name}: {sum(e.count for e in rows)} launches, "
              f"{sum(e.self_device_time_total for e in rows) / 1e3:.3f} ms ({card})")
    # kernel and copy rows only: an operator's row repeats its kernels' time
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    print(f"config {a.config} profiled run: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, device idle share {1 - busy_us / 1e6 / wall:.4f} ({card})")
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    print(f"trace: {trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
