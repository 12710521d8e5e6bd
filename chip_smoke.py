"""Chip check of the PyTorch port: builds the CUDA kernels, holds each
against its plain-torch version on the card (at every bucket side 16-4096,
and both forward kernels above their shared-memory limits, through the
device slab: profiles at side 8192, codes at 16384), and drives the port's
paths on the GPU: config 1 (two 1 Mbp genomes, bench.py) through
MauveAligner, BASELINE config 2 (three 500 kbp genomes with an inversion,
scripts/bench_configs.py) through the mauveAligner command line with
islands and backbone, cold and warm, BASELINE config 3 (9 x 250 kbp,
scripts/bench_configs.py) through ProgressiveMauve (the extant branch of
its gate), 9 x 1 Mbp enterobacteria-like genomes through ProgressiveMauve
(the tree-progressive branch), BASELINE config 4 (the 236 kbp
planted-family genome, scripts/bench_configs.py config4) through
Repeatoire cold and warm, and the same generator with every spacer 4x as
long (926 kbp, bacterial scale) through Repeatoire once.  Each run is held to the JAX package's outputs
recorded in mauvealigner_tpu_torch/data/*_golden.json.

Usage (from the repository root, one NVIDIA GPU):  python3 chip_smoke.py

Kernel checks compare scores exactly and the decision bytes on each
problem's live rectangle (dp.live_cell_mask), the only bytes the forward
kernels write; the traceback kernel is held to the plain traceback on the
plain decisions and on each forward kernel's decisions with every byte
outside the live rectangles poisoned (POISON).  After the driven paths,
config 2's, config 3's and config 4's cold-run launch lists
(gotoh_cuda.LAUNCH_SHAPES) are replayed with random contents at the
recorded lengths (scripts/gotoh_replay.py): each kernel's summed ms, bound
and roofline share print on the "main path" lines, and the traceback's
chain floor beside its bound.

Phases print on their own lines; any failure exits non-zero before the
result line.  The second-to-last line is one JSON object describing each
kernel; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mauvealigner_tpu_torch import native
from mauvealigner_tpu_torch.core.mln import write_match_list
from mauvealigner_tpu_torch.models import repeatoire
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu_torch.ops import _build, dp, gotoh_cuda
from mauvealigner_tpu_torch.tools.cli import main as port_cli
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
# sides above each forward kernel's shared-memory limit (8192 codes, 4096
# profiles on an H100): the device-slab path, B = 2, live lengths above
# the old limits
LARGE_SIDES = {"gotoh_forward_profiles": 8192, "gotoh_forward_codes": 16384}
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


def check_large_sides(dev) -> dict:
    """Both forward kernels above their shared-memory limits (the device
    slab): scores exact, live decision bytes identical, and the traceback
    kernel on the kernel's decisions equal to the plain traceback on the
    plain decisions.  Times: the kernel over 3 launches, the plain version
    and the traceback once each (CUDA events), each beside its bound."""
    rng = np.random.default_rng(2027)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    lib = _build.library()
    sm_mhz = sm_clock_mhz()
    out = {}
    for name, side in LARGE_SIDES.items():
        lens = (np.array([side - 3, side // 2 + 7], np.int32),
                np.array([side - 11, 900], np.int32))
        profiles = name == "gotoh_forward_profiles"
        slab = lib.gotoh_forward_scratch_bytes(2, side, int(profiles), 0)
        if slab <= 0:
            raise SystemExit(f"{name} at side {side} fits shared memory: no slab path to check")
        if profiles:
            pa, pb, la_h, lb_h = random_profile_batch(rng, 2, side, lens)
            x = [torch.from_numpy(pa).to(dev).to(torch.float32),
                 torch.from_numpy(pb).to(dev).to(torch.float32)]
            kernel = gotoh_cuda.gotoh_forward_profiles
            plain = dp.gotoh_forward_profiles_ref
        else:
            ca, cb, la_h, lb_h = random_batch(rng, 2, side, lens)
            x = [torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev)]
            kernel = gotoh_cuda.gotoh_forward_codes
            plain = dp.gotoh_forward_codes_ref
        x += [torch.from_numpy(la_h).to(dev), torch.from_numpy(lb_h).to(dev)]
        s_k, dec_k = kernel(*x, sub, go, ge)
        ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_k, x[2], x[3])
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        s_p, dec_p = plain(*x, sub, go, ge)
        t1.record()
        ops_p, cnt_p = dp.gotoh_traceback_ref(dec_p, x[2], x[3])
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        live = dp.live_cell_mask(x[2], x[3], side, side)
        err = float((s_k - s_p).abs().max())
        same_dec = bool(torch.equal(dec_k[live], dec_p[live]))
        del live, dec_p
        tb_ok = torch.equal(ops_k, ops_p) and torch.equal(cnt_k, cnt_p)
        say(f"{name} device slab side={side} B=2 lengths {la_h.tolist()} x {lb_h.tolist()} "
            f"({slab} slab bytes): scores max|diff|={err}, live dec bytes "
            f"{'identical' if same_dec else 'DIFFER'}, traceback ops and counts "
            f"{'equal' if tb_ok else 'DIFFER'}")
        if not (err == 0.0 and same_dec and tb_ok):
            raise SystemExit(f"{name} disagrees with its plain version at side {side}")
        ms = cuda_ms(lambda: kernel(*x, sub, go, ge), 3)
        bound = forward_bound(name, la_h, lb_h)
        steps = cnt_k.cpu().numpy()
        tb_ms = cuda_ms(lambda: gotoh_cuda.gotoh_traceback(dec_k, x[2], x[3]), 3)
        tb_bound = traceback_bound(steps, side, side)
        floor = traceback_chain_floor(steps, sm_mhz)
        say(f"time device slab side={side} B=2: {name} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}), roofline share "
            f"{bound[0] / ms:.4f}; gotoh_traceback {tb_ms:.4f} ms, bound {tb_bound[0]:.6f} ms, "
            f"chain floor {floor:.4f} ms ({card_line()})")
        out[name] = {"side": side, "batch": 2, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                     "slab_bytes": int(slab), "traceback_ms": tb_ms,
                     "traceback_bound_ms": tb_bound[0], "traceback_chain_floor_ms": floor}
        del dec_k
        torch.cuda.empty_cache()
    return out


def mainpath_times(dev, shapes, config: str) -> dict:
    """Replay a run's recorded launches (random contents at the recorded
    lengths, scripts/gotoh_replay.py): per kernel the summed ms, summed
    bound and roofline share.  These launches count in no run's LAUNCHES:
    the counts are reset before every driven path."""
    res = replay(shapes, gotoh_cuda, dev)
    print_replay(f"main path (config {config} cold-run launch list)", res, card_line())
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


def config2(dev) -> dict:
    """BASELINE config 2 (scripts/bench_configs.py config2: three 500 kbp
    genomes, the second descendant inverted over 150,000-250,000) through
    the port's mauveAligner command line with islands and backbone at 50
    (utils/digest.CONFIG2_ARGS), cold and warm, each held to every field of
    the golden file; every kernel must launch."""
    genomes = digest.config2_genomes(simulate)
    golden = load_golden("config2_golden.json", genomes)
    say("config2 genomes match the golden sha256")
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        digest.write_fasta_files(genomes, d, digest.CONFIG2_SEQS)
        for label in ("cold", "warm"):
            timing.GLOBAL.reset()
            gotoh_cuda.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            with contextlib.chdir(d):
                t0 = time.perf_counter()
                rc = port_cli(["mauveAligner", *digest.CONFIG2_ARGS, f"--device={dev}"])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            launches = dict(gotoh_cuda.LAUNCHES)
            shapes = list(gotoh_cuda.LAUNCH_SHAPES)
            got = digest.mauve_aligner_digest(d)
            c = timing.GLOBAL.counters
            say(f"config2 {label}: {secs:.3f} s, rc {rc}, {json.dumps(got)}, launches {launches}, "
                f"dp_cells {c.get('dp_cells', 0):.0f}, dp_calls {c.get('dp_calls', 0):.0f}")
            say("config2 launch shapes (kernel, side, problems): " + ", ".join(
                f"{s['kernel'].split('_')[-1]} {s['M']} {s['B']}" for s in shapes))
            say(f"config2 {label} per-phase report:\n" + timing.GLOBAL.report().rstrip())
            say(f"config2 {label} peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
            if rc != 0:
                raise SystemExit(f"config2 {label}: mauveAligner returned {rc}")
            for k in digest.CONFIG2_KEYS:
                if got[k] != golden[k]:
                    raise SystemExit(f"config2 {label}: {k} = {got[k]!r}, golden {golden[k]!r}")
            for k in KERNELS:
                if launches[k] <= 0:
                    raise SystemExit(f"config2 {label}: kernel {k} was never launched")
            runs[label] = {"seconds": secs, "launches": launches, "shapes": shapes}
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


def repeatoire_run(genome, golden: dict, label: str, dev) -> dict:
    """Repeatoire on the card as the CLI runs it with --seeds (seeds,
    chaining, then find_repeats on the chained list), every launch count set
    to 0 just before it; held to the golden digest, with every kernel
    launched."""
    rp = repeatoire.Repeatoire(repeatoire.RepeatoireOptions(device=str(dev)))
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml, counts = rp.chain_seed_matches(rp.seed_matches(genome), genome)
    fams = rp.find_repeats(genome, matches=(ml, counts))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(gotoh_cuda.LAUNCHES)
    shapes = list(gotoh_cuda.LAUNCH_SHAPES)
    got = digest.repeatoire_digest(repeatoire, write_match_list, genome, fams, ml)
    c = timing.GLOBAL.counters
    say(f"{label}: {secs:.3f} s, {json.dumps(got)}, launches {launches}, "
        f"dp_cells {c.get('dp_cells', 0):.0f}, dp_calls {c.get('dp_calls', 0):.0f}, "
        f"waves {c.get('rp_ext_waves', 0):.0f}, jobs {c.get('rp_ext_jobs', 0):.0f}")
    say(f"{label} per-phase report:\n" + timing.GLOBAL.report().rstrip())
    say(f"{label} peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for k in digest.REPEATOIRE_KEYS:
        if got[k] != golden[k]:
            raise SystemExit(f"{label}: {k} = {got[k]!r}, golden {golden[k]!r}")
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "launches": launches, "shapes": shapes}


def config4(dev) -> dict:
    """BASELINE config 4 (scripts/bench_configs.py config4: 236 kbp, the
    600 bp unit 8x and the 300 bp unit 4x between random spacers, seed 37),
    default RepeatoireOptions, cold and warm."""
    genome = simulate.planted_repeats(1)
    golden = load_golden("config4_golden.json", [genome])
    say("config4 genome matches the golden sha256")
    return {label: repeatoire_run(genome, golden, f"config4 {label}", dev)
            for label in ("cold", "warm")}


def config4_big(dev) -> dict:
    """Config 4's generator with every spacer 4x as long (926 kbp, the same
    planted families; cut from a bacterial chromosome in length only),
    default RepeatoireOptions, once."""
    genome = simulate.planted_repeats(4)
    golden = load_golden("config4_big_golden.json", [genome])
    say("config4_big genome matches the golden sha256")
    return repeatoire_run(genome, golden, "config4_big", dev)


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
    large = check_large_sides(dev)
    runs = config1(dev)
    runs2 = config2(dev)
    runs3 = config3(dev)
    runs_tree = tree_branch(dev)
    runs4 = config4(dev)
    runs4_big = config4_big(dev)
    mainpath2 = mainpath_times(dev, runs2["cold"]["shapes"], "2")
    mainpath = mainpath_times(dev, runs3["cold"]["shapes"], "3")
    mainpath4 = mainpath_times(dev, runs4["cold"]["shapes"], "4")

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
                "config2": runs2["cold"]["launches"][name],
                "config3": runs3["cold"]["launches"][name],
                "tree": runs_tree["launches"][name],
                "config4": runs4["cold"]["launches"][name],
                "config4_big": runs4_big["launches"][name],
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
            # config 2's and config 4's cold-run launch lists replayed the same way
            "mainpath_config2_ms": mainpath2[name]["ms"],
            "mainpath_config2_bound_ms": mainpath2[name]["bound_ms"],
            "mainpath_config2_launches": mainpath2[name]["launches"],
            "mainpath_config4_ms": mainpath4[name]["ms"],
            "mainpath_config4_bound_ms": mainpath4[name]["bound_ms"],
            "mainpath_config4_launches": mainpath4[name]["launches"],
        })
        if name in large:
            # the largest side checked: above shared memory, the device slab
            kernels[-1]["large_side"] = large[name]
        if name == "gotoh_traceback":
            # the longest walk's dependent steps (scripts/gotoh_replay.py),
            # at the largest timed side and summed over config 3's list
            kernels[-1].update(chain_floor_ms=s["chain_floor_ms"],
                               mainpath_chain_floor_ms=m["chain_floor_ms"],
                               mainpath_after_forward_ms=m["after_forward_ms"],
                               mainpath_config4_chain_floor_ms=mainpath4[name]["chain_floor_ms"])
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
