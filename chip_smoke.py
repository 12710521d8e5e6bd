"""Chip check of the PyTorch port: builds the CUDA kernels, holds each
against its plain-torch version on the card, and drives the port's paths on
the GPU: config 1 (two 1 Mbp genomes, bench.py) through MauveAligner,
BASELINE config 3 (9 x 250 kbp, scripts/bench_configs.py) through
ProgressiveMauve (the extant branch of its gate), and 9 x 1 Mbp
enterobacteria-like genomes through ProgressiveMauve (the tree-progressive
branch).  Each run is held to the JAX package's outputs recorded in
mauvealigner_tpu_torch/data/*_golden.json.

Usage (from the repository root, one NVIDIA GPU):  python3 chip_smoke.py

Phases print on their own lines; any failure exits non-zero before the
result line.  The second-to-last line is one JSON object describing each
kernel; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mauvealigner_tpu_torch import native
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu_torch.ops import _build, dp, gotoh_cuda
from mauvealigner_tpu_torch.utils import digest, simulate, timing

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "mauvealigner_tpu_torch", "data")
SIDES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
TIMED_SIDES = (256, 4096)
# the TPU kernel has two input modes; each is its own CUDA kernel here
KERNELS = {
    "gotoh_forward_codes": "mauvealigner_tpu/ops/dp_pallas.py:182",
    "gotoh_forward_profiles": "mauvealigner_tpu/ops/dp_pallas.py:182",
    "gotoh_traceback": "mauvealigner_tpu/ops/dp.py:286",
}
DIGEST_KEYS = ("branch", "guide_tree", "n_lcbs", "n_intervals",
               "xmfa_sha256", "backbone_sha256", "bbcols_sha256")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_batch(rng, B: int, side: int):
    """Code pairs with lengths below the side, plus edge cases: 1 x 1,
    empty vs non-empty both ways, empty vs empty, and full side."""
    la = rng.integers(1, side + 1, size=B).astype(np.int32)
    lb = rng.integers(1, side + 1, size=B).astype(np.int32)
    edges = [(1, 1), (0, min(5, side)), (min(7, side), 0), (0, 0), (side, side)]
    for k, (x, y) in enumerate(edges[: B // 2]):
        la[k], lb[k] = x, y
    ca = np.full((B, side), 255, np.uint8)
    cb = np.full((B, side), 255, np.uint8)
    for k in range(B):
        a = rng.integers(0, 4, size=la[k]).astype(np.uint8)
        if k % 2:  # unrelated pair: many gaps
            b = rng.integers(0, 4, size=lb[k]).astype(np.uint8)
        else:  # related pair: a, cut or extended to lb, with substitutions
            b = np.resize(a, lb[k]) if la[k] else rng.integers(0, 4, size=lb[k]).astype(np.uint8)
            sub = rng.random(lb[k]) < 0.15
            b[sub] = rng.integers(0, 4, size=int(sub.sum()))
        a[rng.random(la[k]) < 0.01] = 4  # a few ambiguity codes
        ca[k, : la[k]] = a
        cb[k, : lb[k]] = b
    return ca, cb, la, lb


def random_profile_batch(rng, B: int, side: int):
    """uint8 count profiles of 1-9 rows per side (gap cells excluded, a few
    ambiguity codes), zero rows past each length, with random_batch's
    lengths and edge cases; even problems pair related sides."""
    ca, cb, la, lb = random_batch(rng, B, side)
    pa = np.zeros((B, side, 5), np.uint8)
    pb = np.zeros((B, side, 5), np.uint8)
    for out, codes, lens in ((pa, ca, la), (pb, cb, lb)):
        for k in range(B):
            n = int(lens[k])
            rows = int(rng.integers(1, 10))
            cc = np.repeat(codes[k, :n][None, :].astype(np.int64), rows, axis=0)
            mut = rng.random((rows, n)) < 0.1
            cc[mut] = rng.integers(0, 6, size=int(mut.sum()))  # 5 = gap
            for r in range(rows):
                np.add.at(out[k], (np.arange(n)[cc[r] < 5], cc[r][cc[r] < 5]), 1)
    return pa, pb, la, lb


def check_profile_kernel(dev) -> dict:
    """The profile kernel against its plain-torch version at every bucket
    side, normalize off and on: identical decision bytes, scores and
    tracebacks; times at TIMED_SIDES (normalize off, the closure's mode)."""
    rng = np.random.default_rng(2025)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    stats = {"max_abs_err": 0.0}
    for side in SIDES:
        B = 64 if side <= 512 else (16 if side <= 1024 else 10)
        pa_h, pb_h, la_h, lb_h = random_profile_batch(rng, B, side)
        pa = torch.from_numpy(pa_h).to(dev).to(torch.float32)
        pb = torch.from_numpy(pb_h).to(dev).to(torch.float32)
        la, lb = torch.from_numpy(la_h).to(dev), torch.from_numpy(lb_h).to(dev)
        for normalize in (False, True):
            s_k, dec_k = gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, go, ge, normalize)
            s_p, dec_p = dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, go, ge, normalize)
            ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_k, la, lb)
            ops_p, cnt_p = dp.gotoh_traceback_ref(dec_p, la, lb)
            torch.cuda.synchronize()
            err = float((s_k - s_p).abs().max())
            same_dec = bool(torch.equal(dec_k, dec_p))
            tb_ok = torch.equal(ops_k, ops_p) and torch.equal(cnt_k, cnt_p)
            say(f"profile kernel-vs-plain side={side} B={B} normalize={normalize}: "
                f"scores max|diff|={err}, dec bytes {'identical' if same_dec else 'DIFFER'}, "
                f"traceback {'equal' if tb_ok else 'DIFFERS'}")
            if not (err == 0.0 and same_dec and tb_ok):
                raise SystemExit(f"profile kernel disagrees with its plain version at side {side}")
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if side in TIMED_SIDES:
            reps_k = 20 if side <= 512 else 5
            f_k = cuda_ms(lambda: gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, go, ge), reps_k)
            f_p = cuda_ms(lambda: dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, go, ge), 1)
            say(f"time side={side} B={B}: gotoh_forward_profiles kernel {f_k:.4f} ms, plain {f_p:.4f} ms")
            stats.update(ms=f_k, plain_ms=f_p, bucket=side, batch=B)
    return stats


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernels(dev) -> dict:
    """Each kernel against its plain-torch version on the card, at every
    bucket side the closure uses; times at TIMED_SIDES."""
    rng = np.random.default_rng(2024)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    stats = {k: {"max_abs_err": 0.0} for k in ("gotoh_forward_codes", "gotoh_traceback")}
    for side in SIDES:
        B = 64 if side <= 512 else (16 if side <= 1024 else 10)
        ca, cb, la, lb = (torch.from_numpy(x).to(dev) for x in random_batch(rng, B, side))
        s_k, dec_k = gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, go, ge)
        s_p, dec_p = dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, go, ge)
        ops_kp, cnt_kp = dp.gotoh_traceback_ref(dec_k, la, lb)
        ops_pp, cnt_pp = dp.gotoh_traceback_ref(dec_p, la, lb)
        ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_p, la, lb)
        torch.cuda.synchronize()
        err_f = float((s_k - s_p).abs().max())
        same_dec = bool(torch.equal(dec_k, dec_p))
        fwd_ok = err_f == 0.0 and torch.equal(ops_kp, ops_pp) and torch.equal(cnt_kp, cnt_pp)
        err_t = float((ops_k.int() - ops_pp.int()).abs().max())
        tb_ok = torch.equal(ops_k, ops_pp) and torch.equal(cnt_k, cnt_pp)
        say(f"kernel-vs-plain side={side} B={B}: forward scores max|diff|={err_f} "
            f"ops {'equal' if fwd_ok else 'DIFFER'} (dec bytes "
            f"{'identical' if same_dec else 'differ'}); traceback "
            f"{'equal' if tb_ok else 'DIFFERS'}")
        if not (fwd_ok and tb_ok):
            raise SystemExit(f"kernel disagrees with its plain version at side {side}")
        stats["gotoh_forward_codes"]["max_abs_err"] = max(stats["gotoh_forward_codes"]["max_abs_err"], err_f)
        stats["gotoh_traceback"]["max_abs_err"] = max(stats["gotoh_traceback"]["max_abs_err"], err_t)
        if side in TIMED_SIDES:
            reps_k = 20 if side <= 512 else 5
            f_k = cuda_ms(lambda: gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, go, ge), reps_k)
            f_p = cuda_ms(lambda: dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, go, ge), 1)
            t_k = cuda_ms(lambda: gotoh_cuda.gotoh_traceback(dec_p, la, lb), reps_k)
            t_p = cuda_ms(lambda: dp.gotoh_traceback_ref(dec_p, la, lb), 1)
            say(f"time side={side} B={B}: gotoh_forward_codes kernel {f_k:.4f} ms, "
                f"plain {f_p:.4f} ms; gotoh_traceback kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            stats["gotoh_forward_codes"].update(ms=f_k, plain_ms=f_p, bucket=side, batch=B)
            stats["gotoh_traceback"].update(ms=t_k, plain_ms=t_p, bucket=side, batch=B)
    return stats


def config1(dev) -> dict:
    """bench.py config 1 through MauveAligner on the card, held to the
    JAX package's outputs recorded in the golden file."""
    with open(os.path.join(DATA, "config1_golden.json")) as fh:
        golden = json.load(fh)
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 1_000_000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    hashes = [hashlib.sha256(np.ascontiguousarray(g.codes).tobytes()).hexdigest() for g in (anc, der)]
    if hashes != golden["genome_sha256"]:
        raise SystemExit(
            "config-1 genomes differ from the golden file: numpy's generator "
            f"stream differs on this machine ({hashes} vs {golden['genome_sha256']})"
        )
    say("config1 genomes match the golden sha256")
    aligner = MauveAligner(AlignerOptions(use_sml_cache=False, device=str(dev)))
    runs = {}
    for label in ("cold", "warm"):
        timing.GLOBAL.reset()
        gotoh_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aligner.align([anc, der])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(gotoh_cuda.LAUNCHES)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        xmfa = buf.getvalue().encode()
        got = {
            "n_lcbs": len(res.lcbs),
            "n_anchors": len(res.mums),
            "aligned_columns": int(sum(iv.n_cols for iv in res.interval_list.intervals)),
            "xmfa_sha256": hashlib.sha256(xmfa).hexdigest(),
        }
        say(f"config1 {label}: {secs:.3f} s, {json.dumps(got)}, launches {launches}, "
            f"dp_cells {timing.GLOBAL.counters.get('dp_cells', 0):.0f}")
        for k, v in got.items():
            if v != golden[k]:
                raise SystemExit(f"config1 {label}: {k} = {v}, golden {golden[k]}")
        for k in ("gotoh_forward_codes", "gotoh_traceback"):
            if launches[k] <= 0:
                raise SystemExit(f"config1 {label}: kernel {k} was never launched")
        runs[label] = {"seconds": secs, "launches": launches}
        if label == "warm":
            say("per-phase report (warm run):\n" + timing.GLOBAL.report().rstrip())
    say(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return runs


def progressive_run(genomes, golden: dict, label: str, dev, need: tuple) -> dict:
    """One ProgressiveMauve.align on the card with every launch count set to
    0 just before it; held to the golden digest; returns seconds, launches,
    the result and its digest."""
    pm = ProgressiveMauve(ProgressiveOptions(device=str(dev)))
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pm.align(genomes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(gotoh_cuda.LAUNCHES)
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    got = digest.progressive_digest(res, branch, golden["bbcols_name"])
    say(f"{label}: {secs:.3f} s, {json.dumps(got)}, launches {launches}, "
        f"dp_cells {timing.GLOBAL.counters.get('dp_cells', 0):.0f}, "
        f"dp_calls {timing.GLOBAL.counters.get('dp_calls', 0):.0f}")
    say(f"{label} per-phase report:\n" + timing.GLOBAL.report().rstrip())
    say(f"{label} peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for k in DIGEST_KEYS:
        if got[k] != golden[k]:
            raise SystemExit(f"{label}: {k} = {got[k]!r}, golden {golden[k]!r}")
    for k in need:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "launches": launches, "result": res, "digest": got}


def load_golden(name: str, genomes) -> dict:
    with open(os.path.join(DATA, name)) as fh:
        golden = json.load(fh)
    hashes = digest.genome_sha256(genomes)
    if hashes != golden["genome_sha256"]:
        raise SystemExit(f"{name}: genomes differ from the golden file's "
                         "(numpy's generator stream differs on this machine)")
    return golden


def config3(dev) -> dict:
    """BASELINE config 3 (scripts/bench_configs.py config3: 9 x 250 kbp,
    seed 37, sub 0.02, indel 0.001), default options, cold and warm: the
    extant branch of the gate, closure ordered by the guide tree."""
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 250_000)
    genomes = [anc]
    for _ in range(8):
        d, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        genomes.append(d)
    golden = load_golden("config3_golden.json", genomes)
    say("config3 genomes match the golden sha256")
    need = ("gotoh_forward_codes", "gotoh_forward_profiles", "gotoh_traceback")
    runs = {}
    for label in ("cold", "warm"):
        r = progressive_run(genomes, golden, f"config3 {label}", dev, need)
        runs[label] = {"seconds": r["seconds"], "launches": r["launches"]}
    return runs


def tree_branch(dev) -> dict:
    """9 x 1 Mbp enterobacteria-like genomes (the generator of
    scripts/bench_enterobacteria.py), default options: the gate must take the
    tree-progressive branch; each (0, i) pair's sn / ppv against the
    simulation truths must equal the golden's."""
    t0 = time.perf_counter()
    genomes, truths = simulate.enterobacteria_like(1_000_000, 9, 0.08)
    say(f"tree genomes built in {time.perf_counter() - t0:.1f} s (host)")
    golden = load_golden("tree_golden.json", genomes)
    r = progressive_run(
        genomes, golden, "tree", dev, ("gotoh_forward_codes", "gotoh_traceback")
    )
    if r["digest"]["branch"] != "tree":
        raise SystemExit("tree: the gate did not choose the tree-progressive branch")
    acc = digest.pair_accuracy(r["result"].interval_list, truths, [len(g) for g in genomes])
    for a in acc:
        say(f"tree pair {a['pair']}: sn {a['sn']:.6f} ppv {a['ppv']:.6f}")
    if acc != golden["accuracy"]:
        raise SystemExit(f"tree: accuracy {acc} differs from the golden {golden['accuracy']}")
    return {"seconds": r["seconds"], "launches": r["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    say(card_line())
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    say(f"native host module loaded: {native.get() is not None}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    _build.library()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s ({_build.build_info.get('path')})")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")

    stats = check_kernels(dev)
    stats["gotoh_forward_profiles"] = check_profile_kernel(dev)
    runs = config1(dev)
    runs3 = config3(dev)
    runs_tree = tree_branch(dev)

    kernels = []
    for name, replaces in KERNELS.items():
        s = stats[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mauvealigner_tpu_torch/csrc/gotoh.cu",
            "replaces": replaces,
            # launches of the progressive main path (config 3, cold run);
            # each path's own counts beside it
            "launches": runs3["cold"]["launches"][name],
            "launches_by_path": {
                "config1": runs["cold"]["launches"][name],
                "config3": runs3["cold"]["launches"][name],
                "tree": runs_tree["launches"][name],
            },
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bucket": s["bucket"],
            "batch": s["batch"],
        })
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
