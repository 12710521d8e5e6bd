"""Chip check of the PyTorch port: builds the CUDA kernels, holds each
against its plain-torch version on the card (at every bucket side 16-4096,
and both forward kernels above their shared-memory limits, through the
device slab: profiles at side 8192, codes at 16384), and drives the port's
paths on the GPU: config 1 (two 1 Mbp genomes, bench.py) through
MauveAligner, BASELINE config 2 (three 500 kbp genomes with an inversion,
scripts/bench_configs.py) through the mauveAligner command line with
islands and backbone, BASELINE config 3 (9 x 250 kbp,
scripts/bench_configs.py) through ProgressiveMauve (the extant branch of
its gate), 9 x 1 Mbp enterobacteria-like genomes through ProgressiveMauve
(the tree-progressive branch), BASELINE config 4 (the 236 kbp
planted-family genome, scripts/bench_configs.py config4) through
Repeatoire, the same generator with every spacer 4x as
long (926 kbp, bacterial scale) through Repeatoire once, BASELINE config 5
(the draft workflow of scripts/bench_configs.py config5: a 150 kbp
reference and 7 drafts of 6 shuffled, partly inverted contigs, each draft's
anchors through MauveAligner and its contigs through sortContigs, then
ProgressiveMauve of the reference and the reordered drafts),
then sortContigs and uniqueMerCount through the command line on its
reference and first draft, and the same workflow at BASELINE's 20+ drafts
(a 500 kbp reference and 20 drafts of 20 contigs) once.  Then the mesh
phases: config 1 through MauveAligner, config 3 through ProgressiveMauve,
and config 5 and config 5 wide through sort_contigs_sharded and
ProgressiveMauve, each under Mesh((cuda:0,) * 4) (four logical shards on
the one card: the two-phase all-to-all anchor search and every DP and HMM
batch split four ways), and the sharded anchor search of config 1 over a world-size-1
NCCL process group (parallel/multihost.py).  Then the runs at the size
users run: BASELINE.md's headline, 9 x 4.6 Mbp enterobacteria-like genomes
(the genomes of scripts/bench_enterobacteria.py) through ProgressiveMauve's
tree-progressive branch, and Repeatoire on a whole 4.6 Mbp chromosome
(config 4's planted families, every spacer 20x); and the 9 x 1 Mbp tree
branch once more with the ladder's thread pool (MAUVE_TP_WORKERS=4),
whose launch counts must equal the serial run's.  Last, config 5 at
bacterial length, uncut: the draft workflow on a 4.6 Mbp reference and 20
drafts of 184 contigs, then its front half again through
sort_contigs_sharded under Mesh((cuda:0,) * 4) (BASELINE config 5's
pod-sharded half at its real size).  Then BASELINE configs 1, 2 and 3 at
E. coli length, uncut, once each (utils/digest.BACTERIAL_RECIPES): config 1
on two 4.6 Mbp genomes through MauveAligner, config 2 on three through the
mauveAligner command line with islands and backbone, and config 3 on 9 x
4.6 Mbp through ProgressiveMauve's extant branch (tree_progressive=False,
the command line's --tree-progressive=0), with the default gate's sketched
reading of the same genomes.  Each run is held to the
JAX package's outputs recorded in mauvealigner_tpu_torch/data/*_golden.json
(mesh output is bit-identical to single-device output by design, so the
mesh runs use the same files).  The tree branch's, config 5 wide's,
config 5 at bacterial length's and the three E. coli length runs' genomes
build in worker processes while the earlier phases run; the headline
(genomes and run) runs in a worker process of its own beside config 5 at
bacterial length and the E. coli length runs.  Every path runs once.

Usage (from the repository root, one NVIDIA GPU):  python3 chip_smoke.py

Kernel checks compare scores exactly and the decision bytes on each
problem's live rectangle (dp.live_cell_mask), the only bytes the forward
kernels write; the traceback kernel is held to the plain traceback on the
plain decisions and on each forward kernel's decisions with every byte
outside the live rectangles poisoned (POISON).  These comparisons run in
a worker process beside the driven paths; the kernels and their plain
versions are timed after the driven paths, in this process, with nothing
else on the card.  Then
config 2's, config 3's and config 4's cold-run launch lists
(gotoh_cuda.LAUNCH_SHAPES), config 5's, the headline's, config 5 at
bacterial length's and the three E. coli length runs' are replayed with random
contents at the recorded lengths (scripts/gotoh_replay.py): each kernel's
summed ms, bound and roofline share print on the "main path" lines, and the
traceback's chain floor beside its bound.

Phases print on their own lines; any failure exits non-zero before the
result line.  The second-to-last line is one JSON object describing each
kernel; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

import concurrent.futures
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import resource
import socket
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from mauvealigner_tpu_torch import native
from mauvealigner_tpu_torch.core.mln import write_match_list
from mauvealigner_tpu_torch.models import progressive, repeatoire
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu_torch.ops import _build, dp, gotoh_cuda, matchops
from mauvealigner_tpu_torch.parallel import Mesh, find_multi_mums_sharded, multihost
from mauvealigner_tpu_torch.parallel import sort_contigs_sharded
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
MESH_SHARDS = 4  # logical shards on the one card (Mesh((cuda:0,) * 4))
DIGEST_KEYS = ("branch", "guide_tree", "n_lcbs", "n_intervals",
               "xmfa_sha256", "backbone_sha256", "bbcols_sha256")
HEADLINE_KEYS = (*DIGEST_KEYS, "n_anchors", "accuracy")
HEADLINE_SIZE = 4_600_000
POOL_WORKERS = 4  # the tree_pool phase's MAUVE_TP_WORKERS


def say(msg: str) -> None:
    print(msg, flush=True)


def hold(label: str, got: dict, golden: dict, keys) -> None:
    """Exit non-zero at the first of `keys` where the run's digest differs
    from the golden's, or that either lacks."""
    for k in keys:
        if k not in golden or k not in got:
            raise SystemExit(f"{label}: {k} missing from the {'golden' if k not in golden else 'run'}")
        if got[k] != golden[k]:
            raise SystemExit(f"{label}: {k} = {got[k]!r}, golden {golden[k]!r}")


def enterobacteria_digest(res, branch: str, genomes, truths, bbcols_name: str,
                          progressive: dict = None) -> dict:
    """The fields of an enterobacteria golden (scripts/make_port_golden.py
    enterobacteria_golden): the progressive digest (`progressive` when the
    caller has it already: writing the XMFA is most of its cost), the
    anchor count and each (0, i) pair's sn / ppv against the simulation
    truths."""
    got = dict(progressive or digest.progressive_digest(res, branch, bbcols_name))
    got["n_anchors"] = len(res.mums)
    got["accuracy"] = digest.pair_accuracy(res.interval_list, truths, [len(g) for g in genomes])
    return got


def peak_rss_gib() -> float:
    """This process's peak resident set so far, in GiB (Linux counts
    ru_maxrss in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


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


def batch_of(side: int) -> int:
    """Problems per checked batch at one bucket side."""
    return 64 if side <= 512 else (16 if side <= 1024 else 10)


def code_batches(dev):
    """(side, host arrays, device tensors) of code pairs at every side in
    SIDES, drawn from one seed: check_kernels' and time_kernels' inputs."""
    rng = np.random.default_rng(2024)
    for side in SIDES:
        host = random_batch(rng, batch_of(side), side)
        yield side, host, [torch.from_numpy(x).to(dev) for x in host]


def profile_batches(dev):
    """(side, host arrays, device tensors) of count profiles at every side
    in SIDES, drawn from one seed: check_profile_kernel's and time_kernels'
    inputs."""
    rng = np.random.default_rng(2025)
    for side in SIDES:
        pa, pb, la, lb = random_profile_batch(rng, batch_of(side), side)
        yield side, (pa, pb, la, lb), [torch.from_numpy(pa).to(dev).to(torch.float32),
                                       torch.from_numpy(pb).to(dev).to(torch.float32),
                                       torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev)]


def large_batches(dev):
    """(name, side, host lengths, device inputs, kernel, plain version) of
    each forward kernel at its LARGE_SIDES side (B = 2, live lengths above
    the shared-memory limits), drawn from one seed: check_large_sides' and
    time_kernels' inputs."""
    rng = np.random.default_rng(2027)
    for name, side in LARGE_SIDES.items():
        lens = (np.array([side - 3, side // 2 + 7], np.int32),
                np.array([side - 11, 900], np.int32))
        if name == "gotoh_forward_profiles":
            pa, pb, la_h, lb_h = random_profile_batch(rng, 2, side, lens)
            x = [torch.from_numpy(pa).to(dev).to(torch.float32),
                 torch.from_numpy(pb).to(dev).to(torch.float32)]
            kernel, plain = gotoh_cuda.gotoh_forward_profiles, dp.gotoh_forward_profiles_ref
        else:
            ca, cb, la_h, lb_h = random_batch(rng, 2, side, lens)
            x = [torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev)]
            kernel, plain = gotoh_cuda.gotoh_forward_codes, dp.gotoh_forward_codes_ref
        x += [torch.from_numpy(la_h).to(dev), torch.from_numpy(lb_h).to(dev)]
        yield name, side, (la_h, lb_h), x, kernel, plain


def check_profile_kernel(dev) -> dict:
    """The profile kernel against its plain-torch version at every bucket
    side, normalize off and on: scores and every byte of each problem's
    live rectangle identical, tracebacks equal."""
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    stats = {"max_abs_err": 0.0}
    for side, _, (pa, pb, la, lb) in profile_batches(dev):
        B = batch_of(side)
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
    return stats


def check_kernels(dev) -> dict:
    """Each kernel against its plain-torch version on the card, at every
    bucket side the closure uses: forward scores and every byte of each
    problem's live rectangle identical, tracebacks equal."""
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    stats = {k: {"max_abs_err": 0.0} for k in ("gotoh_forward_codes", "gotoh_traceback")}
    for side, _, (ca, cb, la, lb) in code_batches(dev):
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
        say(f"kernel-vs-plain side={side} B={batch_of(side)}: forward scores max|diff|={err_f}, "
            f"live dec bytes ({int(live.sum())}) {'identical' if same_dec else 'DIFFER'}, ops "
            f"{'equal' if fwd_ok else 'DIFFER'}; traceback on the plain and the poisoned "
            f"kernel decisions {'equal' if tb_ok else 'DIFFERS'}")
        if not (fwd_ok and tb_ok):
            raise SystemExit(f"kernel disagrees with its plain version at side {side}")
        stats["gotoh_forward_codes"]["max_abs_err"] = max(stats["gotoh_forward_codes"]["max_abs_err"], err_f)
        stats["gotoh_traceback"]["max_abs_err"] = max(stats["gotoh_traceback"]["max_abs_err"], err_t)
    return stats


def check_large_sides(dev) -> dict:
    """Both forward kernels above their shared-memory limits (the device
    slab): scores exact, live decision bytes identical, and the traceback
    kernel on the kernel's decisions equal to the plain traceback on the
    plain decisions."""
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    lib = _build.library()
    out = {}
    for name, side, (la_h, lb_h), x, kernel, plain in large_batches(dev):
        slab = lib.gotoh_forward_scratch_bytes(2, side, int(name == "gotoh_forward_profiles"), 0)
        if slab <= 0:
            raise SystemExit(f"{name} at side {side} fits shared memory: no slab path to check")
        s_k, dec_k = kernel(*x, sub, go, ge)
        ops_k, cnt_k = gotoh_cuda.gotoh_traceback(dec_k, x[2], x[3])
        s_p, dec_p = plain(*x, sub, go, ge)
        ops_p, cnt_p = dp.gotoh_traceback_ref(dec_p, x[2], x[3])
        torch.cuda.synchronize()
        live = dp.live_cell_mask(x[2], x[3], side, side)
        err = float((s_k - s_p).abs().max())
        same_dec = bool(torch.equal(dec_k[live], dec_p[live]))
        del live, dec_p, dec_k
        tb_ok = torch.equal(ops_k, ops_p) and torch.equal(cnt_k, cnt_p)
        say(f"{name} device slab side={side} B=2 lengths {la_h.tolist()} x {lb_h.tolist()} "
            f"({slab} slab bytes): scores max|diff|={err}, live dec bytes "
            f"{'identical' if same_dec else 'DIFFER'}, traceback ops and counts "
            f"{'equal' if tb_ok else 'DIFFER'}")
        if not (err == 0.0 and same_dec and tb_ok):
            raise SystemExit(f"{name} disagrees with its plain version at side {side}")
        out[name] = {"side": side, "batch": 2, "max_abs_err": err, "slab_bytes": int(slab)}
        torch.cuda.empty_cache()
    return out


def kernel_checks():
    """Every kernel against its plain version on the card: check_kernels,
    check_profile_kernel and check_large_sides.  Runs in a worker process
    of its own (a second CUDA context on the card) beside the driven paths:
    both are host-bound, and the plain versions' small launches take
    minutes.  Nothing is timed here (time_kernels times the same inputs
    later, alone on the card).  Returns (stats by kernel, device-slab
    stats)."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()  # the parent built it: this loads the library
    stats = check_kernels(dev)
    stats["gotoh_forward_profiles"] = check_profile_kernel(dev)
    return stats, check_large_sides(dev)


def plain_ms(fn, warm: bool):
    """(ms, result) of one call of a plain version (CUDA events), after a
    warm call when `warm`.  A plain call takes 0.3-20 s, so one call gives
    its time; the first timed side warms the code every later side runs."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def time_kernels(dev, stats: dict, large: dict) -> None:
    """Time each kernel and its plain version on the inputs kernel_checks
    compared (the same seeds), with nothing else on the card: at
    TIMED_SIDES the forward kernels over 20 launches (5 at sides above
    512, CUDA events, scripts/gotoh_replay.cuda_ms) and the plain versions
    once (plain_ms, warm at the first side only); the traceback likewise
    on the plain decisions.  At LARGE_SIDES each forward kernel and the
    traceback over 3 launches and the plain forward once.  Each time
    prints beside its bound and fills `stats` and `large` in place."""
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    sm_mhz = sm_clock_mhz()
    warm = True
    for side, (_, _, la_h, lb_h), (ca, cb, la, lb) in code_batches(dev):
        if side not in TIMED_SIDES:
            continue
        B, reps_k = batch_of(side), (20 if side <= 512 else 5)
        f_p, (_, dec_p) = plain_ms(lambda: dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, go, ge),
                                   warm)
        t_p, (_, cnt_pp) = plain_ms(lambda: dp.gotoh_traceback_ref(dec_p, la, lb), warm)
        warm = False
        f_k = cuda_ms(lambda: gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, go, ge), reps_k)
        t_k = cuda_ms(lambda: gotoh_cuda.gotoh_traceback(dec_p, la, lb), reps_k)
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
        del dec_p
    warm = True
    for side, (_, _, la_h, lb_h), (pa, pb, la, lb) in profile_batches(dev):
        if side not in TIMED_SIDES:
            continue
        B, reps_k = batch_of(side), (20 if side <= 512 else 5)
        f_k = cuda_ms(lambda: gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, go, ge), reps_k)
        f_p = plain_ms(lambda: dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, go, ge), warm)[0]
        warm = False
        bound = forward_bound("gotoh_forward_profiles", la_h, lb_h)
        say(f"time side={side} B={B}: gotoh_forward_profiles kernel {f_k:.4f} ms, plain "
            f"{f_p:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}), roofline share "
            f"{bound[0] / f_k:.4f}")
        record_time(stats["gotoh_forward_profiles"], side, B, f_k, f_p, bound)
    for name, side, (la_h, lb_h), x, kernel, plain in large_batches(dev):
        p_ms = plain_ms(lambda: plain(*x, sub, go, ge), False)[0]
        ms = cuda_ms(lambda: kernel(*x, sub, go, ge), 3)
        bound = forward_bound(name, la_h, lb_h)
        _, dec_k = kernel(*x, sub, go, ge)
        tb_ms = cuda_ms(lambda: gotoh_cuda.gotoh_traceback(dec_k, x[2], x[3]), 3)
        steps = gotoh_cuda.gotoh_traceback(dec_k, x[2], x[3])[1].cpu().numpy()
        tb_bound = traceback_bound(steps, side, side)
        floor = traceback_chain_floor(steps, sm_mhz)
        say(f"time device slab side={side} B=2: {name} kernel {ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}), roofline share "
            f"{bound[0] / ms:.4f}; gotoh_traceback {tb_ms:.4f} ms, bound {tb_bound[0]:.6f} ms, "
            f"chain floor {floor:.4f} ms ({card_line()})")
        large[name].update(ms=ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                           traceback_ms=tb_ms, traceback_bound_ms=tb_bound[0],
                           traceback_chain_floor_ms=floor)
        del dec_k
        torch.cuda.empty_cache()


def mainpath_times(dev, shapes, config: str) -> dict:
    """Replay a run's recorded launches (random contents at the recorded
    lengths, scripts/gotoh_replay.py): per kernel the summed ms, summed
    bound and roofline share.  These launches count in no run's LAUNCHES:
    the counts are reset before every driven path."""
    res = replay(shapes, gotoh_cuda, dev)
    print_replay(f"main path (config {config} cold-run launch list)", res, card_line())
    return res


def config1_inputs():
    """bench.py config 1's two 1 Mbp genomes and its golden file."""
    with open(os.path.join(DATA, "config1_golden.json")) as fh:
        golden = json.load(fh)
    genomes = digest.config1_genomes(simulate)
    hashes = digest.genome_sha256(genomes)
    if hashes != golden["genome_sha256"]:
        raise SystemExit(
            "config-1 genomes differ from the golden file: numpy's generator "
            f"stream differs on this machine ({hashes} vs {golden['genome_sha256']})"
        )
    say("config1 genomes match the golden sha256")
    return genomes, golden


def aligner_run(aligner, genomes, golden: dict, label: str) -> dict:
    """One MauveAligner.align on the card with every launch count set to 0
    just before it, held to the golden's config 1 fields, with the code-pair
    forward kernel and the traceback launched; returns seconds, launches and
    launch shapes."""
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aligner.align(genomes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(gotoh_cuda.LAUNCHES)
    shapes = list(gotoh_cuda.LAUNCH_SHAPES)
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    xmfa = buf.getvalue().encode()
    got = {
        "n_lcbs": len(res.lcbs),
        "n_anchors": len(res.mums),
        "aligned_columns": int(sum(iv.n_cols for iv in res.interval_list.intervals)),
        "xmfa_sha256": hashlib.sha256(xmfa).hexdigest(),
        "xmfa_bytes": len(xmfa),
    }
    say(f"{label}: {secs:.3f} s, {json.dumps(got)}, launches {launches}, "
        f"dp_cells {timing.GLOBAL.counters.get('dp_cells', 0):.0f}{sharded_note()}")
    hold(label, got, golden, got)
    for k in ("gotoh_forward_codes", "gotoh_traceback"):
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "launches": launches, "shapes": shapes}


def config1(dev, genomes, golden, mesh=None) -> dict:
    """bench.py config 1 through MauveAligner on the card (over `mesh` when
    given) once, held to the JAX package's outputs recorded in the golden
    file."""
    aligner = MauveAligner(AlignerOptions(use_sml_cache=False, device=str(dev), mesh=mesh))
    r = aligner_run(aligner, genomes, golden, "config1" if mesh is None else "config1 mesh")
    if mesh is None:
        say("per-phase report:\n" + timing.GLOBAL.report().rstrip())
    say(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return r


def mauve_aligner_cli_run(dev, directory: str, golden: dict, label: str) -> dict:
    """The port's mauveAligner command line with digest.CONFIG2_ARGS in
    `directory` (its FASTA files written there), every launch count set to
    0 just before it; held to every field of the golden file, with every
    kernel launched; returns seconds, launches and launch shapes."""
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with contextlib.chdir(directory):
        t0 = time.perf_counter()
        rc = port_cli(["mauveAligner", *digest.CONFIG2_ARGS, f"--device={dev}"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(gotoh_cuda.LAUNCHES)
    shapes = list(gotoh_cuda.LAUNCH_SHAPES)
    got = digest.mauve_aligner_digest(directory)
    c = timing.GLOBAL.counters
    say(f"{label}: {secs:.3f} s, rc {rc}, {json.dumps(got)}, launches {launches}, "
        f"dp_cells {c.get('dp_cells', 0):.0f}, dp_calls {c.get('dp_calls', 0):.0f}")
    shapes_line(label, shapes)
    say(f"{label} per-phase report:\n" + timing.GLOBAL.report().rstrip())
    say(f"{label} peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if rc != 0:
        raise SystemExit(f"{label}: mauveAligner returned {rc}")
    hold(label, got, golden, digest.CONFIG2_KEYS)
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "launches": launches, "shapes": shapes}


def shapes_line(label: str, shapes) -> None:
    """A run's launch list (gotoh_cuda.LAUNCH_SHAPES) summed by kernel and
    bucket side: launches and problems."""
    groups = {}
    for s in shapes:
        g = groups.setdefault((s["kernel"].split("_")[-1], int(s["M"])), [0, 0])
        g[0] += 1
        g[1] += int(s["B"])
    say(f"{label} launch shapes (kernel side: launches, problems): " + ", ".join(
        f"{k} {m}: {n}, {b}" for (k, m), (n, b) in sorted(groups.items())))


def config2(dev) -> dict:
    """BASELINE config 2 (scripts/bench_configs.py config2: three 500 kbp
    genomes, the second descendant inverted over 150,000-250,000) through
    the port's mauveAligner command line with islands and backbone at 50
    (utils/digest.CONFIG2_ARGS) once, held to every field of the golden
    file; every kernel must launch."""
    genomes = digest.config2_genomes(simulate)
    golden = load_golden("config2_golden.json", genomes)
    say("config2 genomes match the golden sha256")
    with tempfile.TemporaryDirectory() as d:
        digest.write_fasta_files(genomes, d, digest.CONFIG2_SEQS)
        return mauve_aligner_cli_run(dev, d, golden, "config2")


def sharded_note() -> str:
    """The sharded search's per-shard work counter of the last run, when it
    ran."""
    n = timing.GLOBAL.counters.get("k2_sharded_entries_per_device")
    return "" if n is None else f", k2_sharded_entries_per_device {n:.0f}"


def progressive_run(genomes, golden: dict, label: str, dev, need: tuple, mesh=None,
                    **options) -> dict:
    """One ProgressiveMauve.align on the card (over `mesh` when given, with
    `options` besides) with every launch count set to 0 just before it;
    held to the golden digest; returns seconds, launches, the result and
    its digest."""
    pm = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False, device=str(dev), mesh=mesh,
                                             **options))
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
    t0 = time.perf_counter()
    got = digest.progressive_digest(res, branch, golden["bbcols_name"])
    digest_secs = time.perf_counter() - t0
    say(f"{label}: {secs:.3f} s, {json.dumps(got)}, launches {launches}, "
        f"dp_cells {timing.GLOBAL.counters.get('dp_cells', 0):.0f}, "
        f"dp_calls {timing.GLOBAL.counters.get('dp_calls', 0):.0f}{sharded_note()}")
    say(f"{label} per-phase report:\n" + timing.GLOBAL.report().rstrip())
    say(f"{label} peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    hold(label, got, golden, DIGEST_KEYS)
    for k in need:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "launches": launches, "shapes": shapes, "result": res, "digest": got,
            "digest_seconds": digest_secs, "counters": dict(timing.GLOBAL.counters),
            "phases": dict(timing.GLOBAL.phases)}


def load_golden(name: str, genomes) -> dict:
    with open(os.path.join(DATA, name)) as fh:
        golden = json.load(fh)
    hashes = digest.genome_sha256(genomes)
    if hashes != golden["genome_sha256"]:
        raise SystemExit(f"{name}: genomes differ from the golden file's "
                         "(numpy's generator stream differs on this machine)")
    return golden


def config3(dev, genomes, mesh=None) -> dict:
    """Config 3, default options: the extant branch of the gate, closure
    ordered by the guide tree; once on one device or under `mesh`."""
    golden = load_golden("config3_golden.json", genomes)
    say("config3 genomes match the golden sha256")
    need = ("gotoh_forward_codes", "gotoh_forward_profiles", "gotoh_traceback")
    r = progressive_run(genomes, golden, "config3" if mesh is None else "config3 mesh", dev,
                        need, mesh)
    return {k: r[k] for k in ("seconds", "launches", "shapes")}


def tree_run(genomes, truths, golden: dict, label: str, dev, need: tuple) -> dict:
    """One tree-branch run (progressive_run), its gate branch, anchor count
    and per-pair sn / ppv held to the golden too."""
    r = progressive_run(genomes, golden, label, dev, need)
    if r["digest"]["branch"] != "tree":
        raise SystemExit(f"{label}: the gate did not choose the tree-progressive branch")
    t0 = time.perf_counter()
    got = enterobacteria_digest(r["result"], "tree", genomes, truths, golden["bbcols_name"],
                                r["digest"])
    for a in got["accuracy"]:
        say(f"{label} pair {a['pair']}: sn {a['sn']:.6f} ppv {a['ppv']:.6f}")
    say(f"{label}: {got['n_anchors']} anchors; scoring took {time.perf_counter() - t0:.1f} s "
        f"(after the digest's {r['digest_seconds']:.1f} s)")
    hold(label, got, golden, [k for k in HEADLINE_KEYS if k in golden])
    r["digest"] = got
    return r


def tree_branch(dev, genomes, truths) -> dict:
    """9 x 1 Mbp enterobacteria-like genomes (the generator of
    scripts/bench_enterobacteria.py), default options: the gate must take
    the tree-progressive branch; each (0, i) pair's sn / ppv against the
    simulation truths must equal the golden's."""
    golden = load_golden("tree_golden.json", genomes)
    r = tree_run(genomes, truths, golden, "tree", dev, ("gotoh_forward_codes", "gotoh_traceback"))
    return {"seconds": r["seconds"], "launches": r["launches"]}


def tree_pool(dev, genomes, truths, serial: dict) -> dict:
    """The tree branch's genomes once more with the ladder's independent
    merges on a pool of POOL_WORKERS threads: the same golden, and launch
    counts equal to the serial run's."""
    golden = load_golden("tree_golden.json", genomes)
    with mock.patch.dict(os.environ, {"MAUVE_TP_WORKERS": str(POOL_WORKERS)}):
        r = tree_run(genomes, truths, golden, "tree_pool", dev,
                     ("gotoh_forward_codes", "gotoh_traceback"))
    if "tree_progressive/pool" not in r["phases"]:
        raise SystemExit("tree_pool: the ladder did not run on its thread pool")
    say(f"tree_pool: wall {r['seconds']:.3f} s with {POOL_WORKERS} ladder workers, "
        f"{serial['seconds']:.3f} s serial; ladder {r['phases']['tree_progressive/pool']:.3f} s "
        f"({card_line()})")
    say("tree_pool: launches per kernel pooled / serial: " + ", ".join(
        f"{k} {r['launches'][k]} / {serial['launches'][k]}" for k in KERNELS))
    if r["launches"] != serial["launches"]:
        raise SystemExit(f"tree_pool: launches {r['launches']} differ from the serial run's "
                         f"{serial['launches']}")
    return {"seconds": r["seconds"], "launches": r["launches"]}


def headline(dev, genomes, truths) -> dict:
    """BASELINE.md's headline: 9 x 4.6 Mbp enterobacteria-like genomes
    through ProgressiveMauve(use_sml_cache=False) once, on the
    tree-progressive branch, held to every field of headline_golden.json;
    prints the wall, the phase split, launches, peak device memory and the
    process's peak resident set."""
    golden = load_golden("headline_golden.json", genomes)
    say(f"headline genomes match the golden sha256 ({sum(len(g) for g in genomes):,} bases)")
    r = tree_run(genomes, truths, golden, "headline", dev, tuple(KERNELS))
    say(f"headline: wall {r['seconds']:.3f} s, launches {r['launches']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak resident set of this "
        f"process so far {peak_rss_gib():.2f} GiB; JAX package on the CPU "
        f"{golden['jax_cpu_seconds']:.1f} s ({card_line()})")
    return {"seconds": r["seconds"], "launches": r["launches"], "shapes": r["shapes"]}


def headline_worker() -> dict:
    """The headline phase in a worker process of its own (a second CUDA
    context on the card), beside the main process's later phases: builds
    the genomes, then headline().  Its launch counts are this process's
    own."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()  # the parent built it: this loads the library
    t0 = time.perf_counter()
    secs, (genomes, truths) = build_inputs("headline")
    say(f"headline genomes built in {secs:.1f} s in its worker process")
    r = headline(dev, genomes, truths)
    return {**r, "phase_seconds": time.perf_counter() - t0}


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
    default RepeatoireOptions, once."""
    genome = simulate.planted_repeats(1)
    golden = load_golden("config4_golden.json", [genome])
    say("config4 genome matches the golden sha256")
    return repeatoire_run(genome, golden, "config4", dev)


def config4_chrom(dev) -> dict:
    """Config 4's generator with every spacer 20x as long: a whole
    4,606,000 bp chromosome with the same planted families, default
    RepeatoireOptions, once."""
    genome = simulate.planted_repeats(20)
    golden = load_golden("config4_chrom_golden.json", [genome])
    say(f"config4_chrom genome matches the golden sha256 ({len(genome):,} bp)")
    r = repeatoire_run(genome, golden, "config4_chrom", dev)
    say(f"config4_chrom: wall {r['seconds']:.3f} s, peak resident set of this process so far "
        f"{peak_rss_gib():.2f} GiB; JAX package on the CPU {golden['jax_cpu_seconds']:.1f} s "
        f"({card_line()})")
    return r


def config4_big(dev) -> dict:
    """Config 4's generator with every spacer 4x as long (926 kbp, the same
    planted families; cut from a bacterial chromosome in length only),
    default RepeatoireOptions, once."""
    genome = simulate.planted_repeats(4)
    golden = load_golden("config4_big_golden.json", [genome])
    say("config4_big genome matches the golden sha256")
    return repeatoire_run(genome, golden, "config4_big", dev)


def draft_run(ref, drafts, golden: dict, label: str, dev, mesh=None) -> dict:
    """The draft workflow on the card (utils/digest.sort_drafts: per draft
    MauveAligner's anchor search and LCBs against the reference, then
    sortContigs; then ProgressiveMauve of the reference and the reordered
    drafts), every launch count set to 0 just before it; held to every
    field of the golden, with every kernel launched.  Under a mesh the front
    half is parallel.sort_contigs_sharded (the per-draft searches split over
    the shards) and ProgressiveMauve runs over the mesh."""
    from mauvealigner_tpu_torch.models import aligner as aligner_mod
    from mauvealigner_tpu_torch.tools import manipulate

    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh is None:
        reordered, logs = digest.sort_drafts(ref, drafts, aligner_mod, manipulate, device=str(dev))
    else:
        reordered, logs = map(list, zip(*sort_contigs_sharded(ref, drafts, mesh, device=dev)))
    torch.cuda.synchronize()
    front = time.perf_counter() - t0
    front_peak = torch.cuda.max_memory_allocated()
    timing.GLOBAL.reset()
    res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False, device=str(dev),
                                              mesh=mesh)).align([ref] + reordered)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(gotoh_cuda.LAUNCHES)
    shapes = list(gotoh_cuda.LAUNCH_SHAPES)
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    got = digest.draft_digest(reordered, logs, res, branch, golden["bbcols_name"])
    c = timing.GLOBAL.counters
    say(f"{label}: {secs:.3f} s (front half {front:.3f} s, progressive {secs - front:.3f} s), "
        f"{json.dumps({k: v for k, v in got.items() if k != 'placement_logs'})}, "
        f"launches {launches}, dp_cells {c.get('dp_cells', 0):.0f}, "
        f"dp_calls {c.get('dp_calls', 0):.0f}")
    say(f"{label} placement logs: " + "; ".join(
        " ".join(f"{n}{'+' if s > 0 else '-' if s < 0 else '?'}" for n, s in log)
        for log in got["placement_logs"]))
    say(f"{label} per-phase report (progressive):\n" + timing.GLOBAL.report().rstrip())
    peak = torch.cuda.max_memory_allocated()
    say(f"{label} peak device memory {peak / 2**20:.1f} MiB (front half {front_peak / 2**20:.1f} MiB)")
    hold(label, got, golden, (*digest.DRAFT_KEYS, *DIGEST_KEYS))
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    return {"seconds": secs, "front_half_seconds": front, "launches": launches,
            "shapes": shapes, "peak_bytes": peak, "front_half_peak_bytes": front_peak,
            "dp_cells": c.get("dp_cells", 0)}


def config5(dev, ref, drafts) -> dict:
    """BASELINE config 5 (scripts/bench_configs.py config5: a 150 kbp
    reference and 7 drafts of 6 shuffled, partly inverted contigs, seed 37),
    the draft workflow once; then sortContigs and uniqueMerCount
    through the port's command line on the reference and the first draft."""
    golden = load_golden("config5_golden.json", [ref] + drafts)
    say("config5 genomes match the golden sha256")
    runs = draft_run(ref, drafts, golden, "config5", dev)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        got = digest.draft_cli_digest(port_cli, ref, drafts[0], d, [f"--device={dev}"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    say(f"config5 command lines (sortContigs, uniqueMerCount x 2): {secs:.3f} s, "
        f"{json.dumps(got)}")
    for k in digest.DRAFT_CLI_KEYS:
        if got[k] != golden["cli"][k]:
            raise SystemExit(f"config5 command lines: {k} = {got[k]!r}, golden {golden['cli'][k]!r}")
    runs["cli_seconds"] = secs
    return runs


def config5_wide(dev, ref, drafts, mesh=None) -> dict:
    """The draft workflow at BASELINE's 20+ drafts: a 500 kbp reference and
    20 drafts of 20 contigs (config 5's contig density), once.  Its gate
    takes the tree-progressive branch, as in the JAX package."""
    golden = load_golden("config5_wide_golden.json", [ref] + drafts)
    say("config5_wide genomes match the golden sha256")
    return draft_run(ref, drafts, golden, "config5_wide" if mesh is None else "config5_wide mesh",
                     dev, mesh)


def config5_mesh(dev, ref, drafts, mesh) -> dict:
    """Config 5's draft workflow once under the mesh, against its golden."""
    golden = load_golden("config5_golden.json", [ref] + drafts)
    return draft_run(ref, drafts, golden, "config5 mesh", dev, mesh)


def config5_bacterial(dev, ref, drafts) -> dict:
    """The draft workflow at bacterial length, uncut: a 4.6 Mbp reference
    and 20 drafts of 184 contigs (utils/digest.DRAFT_SHAPES["5bacterial"]), once on
    one device, held to every field of config5_bacterial_golden.json; then
    its front half again through parallel.sort_contigs_sharded under
    Mesh((cuda:0,) * 4) (BASELINE's pod-sharded half at its real size), held
    to the golden's placement logs and reordered drafts.  Prints the wall,
    both front halves, the progressive split, launches, dp_cells, the peak
    device memory of each half and the process's peak resident set."""
    genomes = [ref] + drafts
    golden = load_golden("config5_bacterial_golden.json", genomes)
    say(f"config5_bacterial genomes match the golden sha256 ({sum(len(g) for g in genomes):,} "
        f"bases, {sum(len(d.contigs) for d in drafts)} draft contigs)")
    r = draft_run(ref, drafts, golden, "config5_bacterial", dev)
    say(f"config5_bacterial: wall {r['seconds']:.3f} s (front half {r['front_half_seconds']:.3f} s), "
        f"launches {r['launches']}, dp_cells {r['dp_cells']:.0f}, peak device memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB (front half {r['front_half_peak_bytes'] / 2**30:.2f} GiB), "
        f"peak resident set of this process so far {peak_rss_gib():.2f} GiB; "
        f"JAX package on the CPU {golden['jax_cpu_seconds']:.1f} s (front half "
        f"{golden['jax_cpu_front_seconds']:.1f} s) ({card_line()})")

    # the pod-sharded front half: every pair's mer list padded to the
    # longest pair's, int64 key + int32 sequence + int32 position per entry
    mesh = Mesh((dev,) * MESH_SHARDS)
    longest = max(len(ref) + len(d) for d in drafts)
    pairs = -(-len(drafts) // MESH_SHARDS) * MESH_SHARDS
    say(f"config5_bacterial mesh front half: {pairs} pair rows of up to {longest:,} entries, "
        f"{pairs * longest * 16 / 2**30:.2f} GiB of padded pair tables")
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reordered, logs = map(list, zip(*sort_contigs_sharded(ref, drafts, mesh, device=dev)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = digest.front_half_digest(reordered, logs)
    say(f"config5_bacterial mesh front half: {secs:.3f} s under the {MESH_SHARDS}-shard mesh, "
        f"{r['front_half_seconds']:.3f} s sequential on one device; {got['contigs_placed']} "
        f"contigs placed, launches {dict(gotoh_cuda.LAUNCHES)}, peak device memory "
        f"{peak / 2**30:.2f} GiB{sharded_note()} ({card_line()})")
    hold("config5_bacterial mesh front half", got, golden, digest.FRONT_HALF_KEYS)
    return {**r, "mesh_front_half_seconds": secs, "mesh_front_half_peak_bytes": peak}


def bacterial_line(label: str, r: dict, golden: dict) -> None:
    """An E. coli length run's wall, launches, peaks and launch list, beside
    the JAX package's CPU run of the same genomes."""
    say(f"{label}: wall {r['seconds']:.3f} s, launches {r['launches']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak resident set of this "
        f"process so far {peak_rss_gib():.2f} GiB; JAX package on the CPU "
        f"{golden['jax_cpu_seconds']:.1f} s (genome build {golden['genome_build_seconds']:.1f} s, "
        f"peak resident set {golden['peak_rss_gib']:.2f} GiB) ({card_line()})")
    shapes_line(label, r["shapes"])


def bacterial_golden(name: str, genomes) -> dict:
    golden = load_golden(f"{name}_golden.json", genomes)
    say(f"{name} genomes match the golden sha256 ({sum(len(g) for g in genomes):,} bases)")
    return golden


def config1_bacterial(dev, genomes) -> dict:
    """bench.py config 1 at E. coli length, uncut (two 4.6 Mbp genomes,
    utils/digest.BACTERIAL_RECIPES), through MauveAligner once, held to
    config1_bacterial_golden.json."""
    golden = bacterial_golden("config1_bacterial", genomes)
    aligner = MauveAligner(AlignerOptions(use_sml_cache=False, device=str(dev)))
    r = aligner_run(aligner, genomes, golden, "config1_bacterial")
    say("config1_bacterial per-phase report:\n" + timing.GLOBAL.report().rstrip())
    bacterial_line("config1_bacterial", r, golden)
    return r


def config2_bacterial(dev, genomes) -> dict:
    """BASELINE config 2 at E. coli length, uncut (three 4.6 Mbp genomes,
    the second descendant inverted over 1,380,000-2,300,000), through the
    port's mauveAligner command line with islands and backbone at 50 once,
    held to every field of config2_bacterial_golden.json."""
    golden = bacterial_golden("config2_bacterial", genomes)
    with tempfile.TemporaryDirectory() as d:
        digest.write_fasta_files(genomes, d, digest.CONFIG2_SEQS)
        r = mauve_aligner_cli_run(dev, d, golden, "config2_bacterial")
    bacterial_line("config2_bacterial", r, golden)
    return r


def config3_extant_bacterial(dev, genomes) -> dict:
    """BASELINE config 3 at E. coli length, uncut (9 x 4.6 Mbp), through
    ProgressiveMauve once with tree_progressive=False (the command line's
    --tree-progressive=0): the extant branch, held to
    config3_extant_bacterial_golden.json.  Then the default gate's reading
    of the same genomes: above 4,000,000 bases in all it decides on a 1/16
    sketched search, whose n-way coverage must equal the golden's."""
    golden = bacterial_golden("config3_extant_bacterial", genomes)
    label = "config3_extant_bacterial"
    r = progressive_run(genomes, golden, label, dev, tuple(KERNELS), tree_progressive=False)
    got = {"n_anchors": len(r["result"].mums),
           "nway_coverage": progressive.nway_coverage(r["result"].mums, genomes)}
    say(f"{label}: {got['n_anchors']} anchors, n-way coverage {got['nway_coverage']:.4f}; "
        f"digest {r['digest_seconds']:.1f} s")
    hold(label, {**r["digest"], **got}, golden, tuple(got))
    if r["digest"]["branch"] != "extant":
        raise SystemExit(f"{label}: the run took the {r['digest']['branch']} branch")
    bacterial_line(label, r, golden)
    opts = ProgressiveOptions(use_sml_cache=False, device=str(dev))
    t0 = time.perf_counter()
    sketch = ProgressiveMauve(opts).find_matches(genomes, sketch_mod=opts.distance_sketch)
    torch.cuda.synchronize()
    cov = progressive.nway_coverage(sketch, genomes)
    gate = {"sketch_mod": opts.distance_sketch, "sketched_nway_coverage": cov,
            "threshold": opts.tree_progressive_threshold,
            "auto_branch": "tree" if cov < opts.tree_progressive_threshold else "extant"}
    say(f"{label} default gate: 1/{gate['sketch_mod']} sketched n-way coverage {cov:.4f} against "
        f"the threshold {gate['threshold']}, so the default options take the "
        f"{gate['auto_branch']} branch (full density: {got['nway_coverage']:.4f}); sketched "
        f"search {time.perf_counter() - t0:.3f} s ({card_line()})")
    hold(f"{label} default gate", gate, golden["gate"], gate)
    return {k: r[k] for k in ("seconds", "launches", "shapes")}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def process_group_search(dev, genomes) -> dict:
    """The sharded anchor search of config 1 over a world-size-1 NCCL
    process group (init_multihost, global_mesh: the collectives are
    torch.distributed calls), against the single-device search on the same
    mer lists; the group is destroyed afterwards."""
    import torch.distributed as dist

    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback only
    t0 = time.perf_counter()
    multihost.init_multihost(f"localhost:{free_port()}", 1, 0, device=dev.type, force=True)
    try:
        nccl = torch.cuda.nccl.version() if dev.type == "cuda" else "none"
        say(f"process group: backend {dist.get_backend()}, world size {dist.get_world_size()}, "
            f"NCCL {'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl}, "
            f"init {time.perf_counter() - t0:.3f} s")
        mesh = multihost.global_mesh(dev.type)
        seed = get_seed(default_mer_size(int(np.mean([len(g) for g in genomes]))), 0)
        smls = [build_mer_list_device(g, seed, dev) for g in genomes]
        single = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
        timing.GLOBAL.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ml = find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    rows = lambda m: np.unique(np.concatenate([m.starts, m.lengths[:, None]], axis=1), axis=0)  # noqa: E731
    same = len(ml) == len(single) and np.array_equal(rows(ml), rows(single))
    say(f"process group search (mesh of {mesh.size} rank, group {mesh.group is not None}): "
        f"{secs:.3f} s, {len(ml)} matches, single-device {len(single)}, "
        f"{'equal' if same else 'DIFFER'}{sharded_note()}")
    if not same:
        raise SystemExit("process group search differs from the single-device search")
    return {"seconds": secs, "matches": len(ml)}


def build_inputs(kind: str):
    """(seconds, genomes) of one host genome build; runs in a worker
    process."""
    t0 = time.perf_counter()
    if kind == "tree":
        out = simulate.enterobacteria_like(1_000_000, 9, 0.08)
    elif kind == "headline":
        out = simulate.enterobacteria_like(HEADLINE_SIZE, 9, 0.08)
    elif kind == "config5_wide":
        out = simulate.draft_genomes(*digest.DRAFT_SHAPES["5wide"])
    elif kind == "config5_bacterial":
        out = simulate.draft_genomes(*digest.DRAFT_SHAPES["5bacterial"])
    elif kind in digest.BACTERIAL_RECIPES:
        out = digest.bacterial_genomes(kind, simulate)
    else:
        raise ValueError(kind)
    return time.perf_counter() - t0, out


def take_built(kind: str, future):
    """A worker's genomes, with its build time and how long this process
    waited for them."""
    t0 = time.perf_counter()
    secs, out = future.result()
    say(f"{kind} genomes built in {secs:.1f} s in a worker process; waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    return out


def mesh_launch_line(name: str, mesh_launches: dict, single_launches: dict) -> None:
    say(f"{name}: launches per kernel under the {MESH_SHARDS}-shard mesh / single device: " + ", ".join(
        f"{k} {mesh_launches[k]} / {single_launches[k]}" for k in KERNELS))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # the six largest host genome builds (config 5 bacterial's about 2
    # minutes) run in worker processes while the kernels build and the
    # earlier phases run, one more worker runs the kernel checks and one
    # the headline; spawn, as this process is about to use CUDA
    kinds = ("config5_bacterial", "config5_wide", "tree", *digest.BACTERIAL_RECIPES)
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=len(kinds) + 2, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        built = {kind: pool.submit(build_inputs, kind) for kind in kinds}
        kernels, mesh_summary, walls = run_phases(pool, built)
    say(f"mesh summary: {json.dumps(mesh_summary)}")
    say(f"phase walls (s, host clock, each with its checks and digests; {card_line()}): "
        f"{json.dumps(walls)}")
    say(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run_phases(pool, built):
    """Every phase in order, the kernel checks on `pool` beside them;
    returns the kernels line's list, a summary of the mesh phases and each
    phase's wall seconds."""
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

    walls = {}
    lap_start = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - lap_start[0], 1)
        lap_start[0] = now

    checks = pool.submit(kernel_checks)
    c1_genomes, c1_golden = config1_inputs()
    runs = config1(dev, c1_genomes, c1_golden)
    lap("config1")
    runs2 = config2(dev)
    lap("config2")
    c3_genomes = digest.config3_genomes(simulate)
    runs3 = config3(dev, c3_genomes)
    lap("config3")
    tree_genomes, tree_truths = take_built("tree", built["tree"])
    runs_tree = tree_branch(dev, tree_genomes, tree_truths)
    lap("tree")
    runs_pool = tree_pool(dev, tree_genomes, tree_truths, runs_tree)
    lap("tree_pool")
    runs4 = config4(dev)
    lap("config4")
    runs4_big = config4_big(dev)
    lap("config4_big")
    t0 = time.perf_counter()
    c5_ref, c5_drafts = simulate.draft_genomes(*digest.DRAFT_SHAPES["5"])
    say(f"config5 genomes built in {time.perf_counter() - t0:.1f} s (host)")
    runs5 = config5(dev, c5_ref, c5_drafts)
    lap("config5")
    w_ref, w_drafts = take_built("config5_wide", built["config5_wide"])
    runs5_wide = config5_wide(dev, w_ref, w_drafts)
    lap("config5_wide")

    # the mesh phases: four logical shards on the one card, each run held to
    # the golden of its single-device phase
    mesh = Mesh((dev,) * MESH_SHARDS)
    say(f"mesh: {MESH_SHARDS} shards on {dev} ({card_line()}); four shards on one card "
        "measure correctness and overhead, not scaling")
    mesh_runs = {
        "config1_mesh": config1(dev, c1_genomes, c1_golden, mesh),
        "config3_mesh": config3(dev, c3_genomes, mesh),
        "config5_mesh": config5_mesh(dev, c5_ref, c5_drafts, mesh),
        "config5_wide_mesh": config5_wide(dev, w_ref, w_drafts, mesh),
    }
    # beside the single-device runs
    single = {"config1_mesh": runs, "config3_mesh": runs3, "config5_mesh": runs5,
              "config5_wide_mesh": runs5_wide}
    for name, r in mesh_runs.items():
        mesh_launch_line(name, r["launches"], single[name]["launches"])
        say(f"{name}: wall {r['seconds']:.3f} s under the mesh, {single[name]['seconds']:.3f} s "
            f"on one device ({card_line()})")
    pg = process_group_search(dev, c1_genomes)
    lap("mesh_runs")

    # the sizes users run: a whole chromosome, then the headline in a
    # worker process beside config 5 at bacterial length and the E. coli
    # length runs (each is host-bound and leaves the card idle 96-99% of
    # its time; run one after the other, they took about 1170 s in all on
    # a slow host, near the 1200 s a chip check may take)
    runs4_chrom = config4_chrom(dev)
    lap("config4_chrom")
    headline_run = pool.submit(headline_worker)
    b_ref, b_drafts = take_built("config5_bacterial", built["config5_bacterial"])
    runs5_bact = config5_bacterial(dev, b_ref, b_drafts)
    del b_ref, b_drafts
    lap("config5_bacterial")
    # BASELINE configs 1, 2 and 3 at E. coli length, uncut, once each
    runs_bact = {}
    for kind, run in (("config1_bacterial", config1_bacterial),
                      ("config2_bacterial", config2_bacterial),
                      ("config3_extant_bacterial", config3_extant_bacterial)):
        runs_bact[kind] = run(dev, take_built(kind, built[kind]))
        lap(kind)
    t0 = time.perf_counter()
    runs_headline = headline_run.result()
    say(f"headline done in its worker process in {runs_headline['phase_seconds']:.1f} s "
        f"(genome build included); waited {time.perf_counter() - t0:.1f} s for it")
    walls["headline_worker"] = round(runs_headline["phase_seconds"], 1)
    lap("headline_wait")

    t0 = time.perf_counter()
    stats, large = checks.result()
    say(f"kernel checks done in their worker process; waited {time.perf_counter() - t0:.1f} s "
        "for them")
    time_kernels(dev, stats, large)
    lap("time_kernels")
    mainpath2 = mainpath_times(dev, runs2["shapes"], "2")
    mainpath = mainpath_times(dev, runs3["shapes"], "3")
    mainpath4 = mainpath_times(dev, runs4["shapes"], "4")
    mainpath5 = mainpath_times(dev, runs5["shapes"], "5")
    mainpath_h = mainpath_times(dev, runs_headline["shapes"], "headline")
    mainpath_5b = mainpath_times(dev, runs5_bact["shapes"], "5 bacterial")
    mainpath_bact = {kind: mainpath_times(dev, r["shapes"],
                                          kind.replace("config", "", 1).replace("_", " "))
                     for kind, r in runs_bact.items()}
    lap("replays")

    kernels = []
    for name, replaces in KERNELS.items():
        s = stats[name]
        m = mainpath[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mauvealigner_tpu_torch/csrc/gotoh.cu",
            "replaces": replaces,
            # launches of the draft workflow's main path (config 5, cold
            # run); each path's own counts beside it
            "launches": runs5["launches"][name],
            "launches_by_path": {
                "config1": runs["launches"][name],
                "config2": runs2["launches"][name],
                "config3": runs3["launches"][name],
                "tree": runs_tree["launches"][name],
                "tree_pool": runs_pool["launches"][name],
                "config4": runs4["launches"][name],
                "config4_big": runs4_big["launches"][name],
                "config4_chrom": runs4_chrom["launches"][name],
                "headline": runs_headline["launches"][name],
                "config5": runs5["launches"][name],
                "config5_wide": runs5_wide["launches"][name],
                "config5_bacterial": runs5_bact["launches"][name],
                **{k: r["launches"][name] for k, r in runs_bact.items()},
                **{k: r["launches"][name] for k, r in mesh_runs.items()},
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
            # config 2's, 4's, 5's, the headline's and config 5 at
            # bacterial length's cold-run launch lists replayed the same way
            "mainpath_config2_ms": mainpath2[name]["ms"],
            "mainpath_config2_bound_ms": mainpath2[name]["bound_ms"],
            "mainpath_config2_launches": mainpath2[name]["launches"],
            "mainpath_config4_ms": mainpath4[name]["ms"],
            "mainpath_config4_bound_ms": mainpath4[name]["bound_ms"],
            "mainpath_config4_launches": mainpath4[name]["launches"],
            "mainpath_config5_ms": mainpath5[name]["ms"],
            "mainpath_config5_bound_ms": mainpath5[name]["bound_ms"],
            "mainpath_config5_launches": mainpath5[name]["launches"],
            "mainpath_headline_ms": mainpath_h[name]["ms"],
            "mainpath_headline_bound_ms": mainpath_h[name]["bound_ms"],
            "mainpath_headline_launches": mainpath_h[name]["launches"],
            "mainpath_config5_bacterial_ms": mainpath_5b[name]["ms"],
            "mainpath_config5_bacterial_bound_ms": mainpath_5b[name]["bound_ms"],
            "mainpath_config5_bacterial_launches": mainpath_5b[name]["launches"],
        })
        # the E. coli length runs' launch lists; a kernel a list never
        # launches (config 1's profile kernel) has no times, only its count
        for kind, m_b in mainpath_bact.items():
            r = m_b.get(name, {"ms": None, "bound_ms": None, "launches": 0,
                               "chain_floor_ms": None})
            kernels[-1].update({f"mainpath_{kind}_ms": r["ms"],
                                f"mainpath_{kind}_bound_ms": r["bound_ms"],
                                f"mainpath_{kind}_launches": r["launches"]})
            if name == "gotoh_traceback":
                kernels[-1][f"mainpath_{kind}_chain_floor_ms"] = r["chain_floor_ms"]
        if name in large:
            # the largest side checked: above shared memory, the device slab
            kernels[-1]["large_side"] = large[name]
        if name == "gotoh_traceback":
            # the longest walk's dependent steps (scripts/gotoh_replay.py),
            # at the largest timed side and summed over config 3's list
            kernels[-1].update(chain_floor_ms=s["chain_floor_ms"],
                               mainpath_chain_floor_ms=m["chain_floor_ms"],
                               mainpath_after_forward_ms=m["after_forward_ms"],
                               mainpath_config4_chain_floor_ms=mainpath4[name]["chain_floor_ms"],
                               mainpath_config5_chain_floor_ms=mainpath5[name]["chain_floor_ms"],
                               mainpath_headline_chain_floor_ms=mainpath_h[name]["chain_floor_ms"],
                               mainpath_config5_bacterial_chain_floor_ms=(
                                   mainpath_5b[name]["chain_floor_ms"]))
    return kernels, {
        "shards": MESH_SHARDS,
        "seconds": {k: r["seconds"] for k, r in mesh_runs.items()},
        "single_device_seconds": {k: single[k]["seconds"] for k in mesh_runs},
        "process_group": pg,
        "config5_bacterial_front_half_seconds": runs5_bact["mesh_front_half_seconds"],
        "config5_bacterial_front_half_single_device_seconds": runs5_bact["front_half_seconds"],
    }, walls


if __name__ == "__main__":
    sys.exit(main())
