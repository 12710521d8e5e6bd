"""Chip check of the PyTorch port: builds the CUDA kernels, holds each
against its plain-torch version on the card, and drives the port's paths on
the GPU: config 1 (two 1 Mbp genomes, bench.py) through MauveAligner,
BASELINE config 3 (9 x 250 kbp, scripts/bench_configs.py) through
ProgressiveMauve (the extant branch of its gate), and 9 x 1 Mbp
enterobacteria-like genomes through ProgressiveMauve (the tree-progressive
branch).  Each run is held to the JAX package's outputs recorded in
mauvealigner_tpu_torch/data/*_golden.json.

Usage (from the repository root, one NVIDIA GPU):  python3 chip_smoke.py

Kernel checks compare scores exactly and the decision bytes on each
problem's live rectangle (dp.live_cell_mask), the only bytes the forward
kernels write; the traceback kernel is held to the plain traceback on the
plain decisions and on each forward kernel's decisions with every byte
outside the live rectangles poisoned (POISON).  After the driven paths,
config 3's cold-run launch list (gotoh_cuda.LAUNCH_SHAPES) is replayed with
random contents at the recorded lengths (scripts/gotoh_replay.py): each
kernel's summed ms, bound and roofline share print on the "main path"
lines, and the traceback's chain floor beside its bound.

Phases print on their own lines; any failure exits non-zero before the
result line.  The second-to-last line is one JSON object describing each
kernel; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

import hashlib
import io
import json
import os
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from gotoh_replay import (  # noqa: E402
    TB_CYCLES_PER_STEP, card_line, cuda_ms, forward_bound, print_replay, random_batch,
    random_profile_batch, replay, sm_clock_mhz, traceback_bound, traceback_chain_floor,
)

DATA = os.path.join(ROOT, "mauvealigner_tpu_torch", "data")
SIDES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
TIMED_SIDES = (256, 4096)
# the TPU kernel has two input modes; each is its own CUDA kernel here
KERNELS = {
    "gotoh_forward_codes": "mauvealigner_tpu/ops/dp_pallas.py:183",
    "gotoh_forward_profiles": "mauvealigner_tpu/ops/dp_pallas.py:183",
    "gotoh_traceback": "mauvealigner_tpu/ops/dp.py:286",
}
POISON = 0xEE
DIGEST_KEYS = ("branch", "guide_tree", "n_lcbs", "n_intervals",
               "xmfa_sha256", "backbone_sha256", "bbcols_sha256")


def say(msg: str) -> None:
    print(msg, flush=True)


def record_time(stats: dict, side: int, B: int, ms: float, plain_ms: float, bound,
                **extra) -> None:
    """Keep one timed shape's numbers; the last timed side (the largest)
    fills the kernel's top-level ms / plain_ms / bound_ms (and extra)."""
    bound_ms, bound_by = bound
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "roofline_share": bound_ms / ms, "batch": B, **extra}
    stats.setdefault("by_side", {})[side] = row
    stats.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bucket=side,
                 batch=B, **extra)


def poisoned_traceback_ok(dec, live, la, lb, ops_ref, cnt_ref) -> bool:
    """The traceback kernel on a forward kernel's decisions with every byte
    outside the live rectangles set to POISON equals the plain traceback."""
    dec = dec.clone()
    dec[~live] = POISON
    ops, cnt = gotoh_cuda.gotoh_traceback(dec, la, lb)
    torch.cuda.synchronize()
    return torch.equal(ops, ops_ref) and torch.equal(cnt, cnt_ref)


def check_profile_kernel(dev) -> dict:
    """The profile kernel against its plain-torch version at every bucket
    side, normalize off and on: scores and every byte of each problem's
    live rectangle identical, tracebacks equal; times at TIMED_SIDES
    (normalize off, the closure's mode)."""
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
        live = dp.live_cell_mask(la, lb, side, side)
        for normalize in (False, True):
            s_k, dec_k = gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, go, ge, normalize)
            s_p, dec_p = dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, go, ge, normalize)
            ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_k, la, lb)
            ops_p, cnt_p = dp.gotoh_traceback_ref(dec_p, la, lb)
            torch.cuda.synchronize()
            err = float((s_k - s_p).abs().max())
            same_dec = bool(torch.equal(dec_k[live], dec_p[live]))
            tb_ok = torch.equal(ops_k, ops_p) and torch.equal(cnt_k, cnt_p)
            poison_ok = poisoned_traceback_ok(dec_k, live, la, lb, ops_p, cnt_p)
            say(f"profile kernel-vs-plain side={side} B={B} normalize={normalize}: "
                f"scores max|diff|={err}, live dec bytes ({int(live.sum())}) "
                f"{'identical' if same_dec else 'DIFFER'}, traceback {'equal' if tb_ok else 'DIFFERS'}"
                f", on poisoned dead bytes {'equal' if poison_ok else 'DIFFERS'}")
            if not (err == 0.0 and same_dec and tb_ok and poison_ok):
                raise SystemExit(f"profile kernel disagrees with its plain version at side {side}")
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if side in TIMED_SIDES:
            reps_k = 20 if side <= 512 else 5
            f_k = cuda_ms(lambda: gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, go, ge), reps_k)
            f_p = cuda_ms(lambda: dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, go, ge), 1)
            bound = forward_bound("gotoh_forward_profiles", la_h, lb_h)
            say(f"time side={side} B={B}: gotoh_forward_profiles kernel {f_k:.4f} ms, plain "
                f"{f_p:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}), roofline share "
                f"{bound[0] / f_k:.4f}")
            record_time(stats, side, B, f_k, f_p, bound)
    return stats


def check_kernels(dev) -> dict:
    """Each kernel against its plain-torch version on the card, at every
    bucket side the closure uses: forward scores and every byte of each
    problem's live rectangle identical, tracebacks equal; times at
    TIMED_SIDES."""
    rng = np.random.default_rng(2024)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    sm_mhz = sm_clock_mhz()
    stats = {k: {"max_abs_err": 0.0} for k in ("gotoh_forward_codes", "gotoh_traceback")}
    for side in SIDES:
        B = 64 if side <= 512 else (16 if side <= 1024 else 10)
        ca_h, cb_h, la_h, lb_h = random_batch(rng, B, side)
        ca, cb, la, lb = (torch.from_numpy(x).to(dev) for x in (ca_h, cb_h, la_h, lb_h))
        live = dp.live_cell_mask(la, lb, side, side)
        s_k, dec_k = gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, go, ge)
        s_p, dec_p = dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, go, ge)
        ops_kp, cnt_kp = dp.gotoh_traceback_ref(dec_k, la, lb)
        ops_pp, cnt_pp = dp.gotoh_traceback_ref(dec_p, la, lb)
        ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_p, la, lb)
        torch.cuda.synchronize()
        err_f = float((s_k - s_p).abs().max())
        same_dec = bool(torch.equal(dec_k[live], dec_p[live]))
        fwd_ok = (err_f == 0.0 and same_dec and torch.equal(ops_kp, ops_pp)
                  and torch.equal(cnt_kp, cnt_pp))
        err_t = float((ops_k.int() - ops_pp.int()).abs().max())
        tb_ok = (torch.equal(ops_k, ops_pp) and torch.equal(cnt_k, cnt_pp)
                 and poisoned_traceback_ok(dec_k, live, la, lb, ops_pp, cnt_pp))
        say(f"kernel-vs-plain side={side} B={B}: forward scores max|diff|={err_f}, live dec "
            f"bytes ({int(live.sum())}) {'identical' if same_dec else 'DIFFER'}, ops "
            f"{'equal' if fwd_ok else 'DIFFER'}; traceback on the plain and the poisoned "
            f"kernel decisions {'equal' if tb_ok else 'DIFFERS'}")
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
            f_b = forward_bound("gotoh_forward_codes", la_h, lb_h)
            steps = cnt_pp.cpu().numpy()
            t_b = traceback_bound(steps, side, side)
            floor = traceback_chain_floor(steps, sm_mhz)
            say(f"time side={side} B={B}: gotoh_forward_codes kernel {f_k:.4f} ms, plain "
                f"{f_p:.4f} ms, bound {f_b[0]:.6f} ms ({f_b[1]}), roofline share "
                f"{f_b[0] / f_k:.4f}; gotoh_traceback kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                f"bound {t_b[0]:.6f} ms, roofline share {t_b[0] / t_k:.4f}, chain floor "
                f"{floor:.4f} ms (longest walk {int(steps.max())} steps x {TB_CYCLES_PER_STEP} "
                f"cycles at {sm_mhz:.0f} MHz), {t_k / floor:.2f}x the floor")
            record_time(stats["gotoh_forward_codes"], side, B, f_k, f_p, f_b)
            record_time(stats["gotoh_traceback"], side, B, t_k, t_p, t_b, chain_floor_ms=floor)
    return stats


def mainpath_times(dev, shapes) -> dict:
    """Replay a progressive run's recorded launches (random contents at the
    recorded lengths, scripts/gotoh_replay.py): per kernel the summed ms,
    summed bound and roofline share.  These launches count in no run's
    LAUNCHES: the counts are reset before every driven path."""
    res = replay(shapes, gotoh_cuda, dev)
    print_replay("main path (config 3 cold-run launch list)", res, card_line())
    return res


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
    shapes = list(gotoh_cuda.LAUNCH_SHAPES)
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
    return {"seconds": secs, "launches": launches, "shapes": shapes, "result": res, "digest": got}


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
        runs[label] = {"seconds": r["seconds"], "launches": r["launches"], "shapes": r["shapes"]}
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
    mainpath = mainpath_times(dev, runs3["cold"]["shapes"])

    kernels = []
    for name, replaces in KERNELS.items():
        s = stats[name]
        m = mainpath[name]
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
            # ms, plain_ms and bound_ms at the largest timed side
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"],
            # no PyTorch call computes a Gotoh DP
            "library_ms": None,
            "bucket": s["bucket"],
            "batch": s["batch"],
            "by_side": s["by_side"],
            # config 3's cold-run launch list replayed: summed kernel ms and bound
            "mainpath_ms": m["ms"],
            "mainpath_bound_ms": m["bound_ms"],
            "mainpath_launches": m["launches"],
        })
        if name == "gotoh_traceback":
            # the longest walk's dependent steps (scripts/gotoh_replay.py),
            # at the largest timed side and summed over config 3's list
            kernels[-1].update(chain_floor_ms=s["chain_floor_ms"],
                               mainpath_chain_floor_ms=m["chain_floor_ms"],
                               mainpath_after_forward_ms=m["after_forward_ms"])
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
