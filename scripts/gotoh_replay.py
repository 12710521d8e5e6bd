"""Time the port's Gotoh kernels on a run's own launch list, beside their
bounds.

A run of the port records every forward call of dp.align_*_batch_async in
gotoh_cuda.LAUNCH_SHAPES (kernel, M, N, B and the host lengths).  This
module draws random contents at those lengths (as chip_smoke.py's
random_batch / random_profile_batch draw them, from a seed), replays each
launch on the card (forward kernel, then the traceback on its decisions),
and sums the kernel times per kernel name with CUDA events.  The bound of a
launch is the larger of its bytes over 3.35 TB/s and its f32 operations
over 67 TFLOP/s (one H100 SXM, NVIDIA's data sheet), counted on the live
cells: each input row read once, one decision byte per live cell written;
for the traceback, one decision byte per step of each walk read, the ops
and counts written.  The traceback's chain floor is its longest walk times
TB_CYCLES_PER_STEP cycles at the card's maximum SM clock (nvidia-smi).
The traceback is timed twice: repeated on the same decisions (as the
forward kernels are), and once right after the forward launch that wrote
its decisions ("after forward"), as a run of the port calls it.

Usage (one NVIDIA GPU, from the repository root):
    python3 scripts/gotoh_replay.py record OUT.npz          # config 3's cold-run list
    python3 scripts/gotoh_replay.py replay OUT.npz [--root DIR] [--warps W ...]
                                                  [--per-block P ...]
    python3 scripts/gotoh_replay.py sides [--root DIR] [--per-block P ...]

`sides` times the traceback alone at sides 256 (B=64) and 4096 (B=10) on
code-pair decisions drawn as chip_smoke.py draws them (seed 2024, one
batch per side), beside its bound and chain floor.

`replay --root DIR` imports the port's package from DIR (another checkout,
for example the parent commit unpacked into a git-ignored directory), so two
versions of the kernels replay the same list in one process each.
`--warps` forces the forward kernels' warps per problem and `--per-block`
the traceback's problems a block (this checkout's library only); each
prints one line per value.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# f32 operations per live cell: E, F (2 adds, a compare, a max each), the
# diagonal add and two compares; a profile cell adds 5 products and 4 sums
OPS_PER_CELL = {"gotoh_forward_codes": 12, "gotoh_forward_profiles": 21}
# input bytes per live row: a code byte, or 5 f32 counts
ROW_BYTES = {"gotoh_forward_codes": 1, "gotoh_forward_profiles": 20}
# cycles of one dependent traceback step in csrc/gotoh.cu's design: a
# shared-memory load (about 30 cycles on Hopper) and about five dependent
# integer operations (the source select, the offset delta and add, 4 cycles
# each)
TB_CYCLES_PER_STEP = 50


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls after one warm call (CUDA events).
    A device sleep of about 10 ms queued first holds the stream while the
    host enqueues the calls, so launches shorter than the host's enqueue
    time run back to back and the events measure device time, not the
    host (a 2 ms sleep let one replay in three calls read 3.8x high)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_ms_after(first, fn, reps: int) -> float:
    """Mean ms of one fn(first()) launched right after first() (CUDA events
    around fn alone), over reps pairs; each pair is queued behind a device sleep,
    as in cuda_ms, so fn starts when first ends."""
    fn(first())
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        x = first()
        t0.record()
        fn(x)
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def random_batch(rng, B: int, side: int, lens=None, side_b=None):
    """Code pairs [B, side] / [B, side_b] padded with 255.  Without `lens`,
    lengths are drawn below the sides plus edge cases (1 x 1, empty vs
    non-empty both ways, empty vs empty, full side); with `lens` = (la, lb)
    those lengths are kept.  The contents are drawn for every problem at
    once (a recorded launch may hold 10^5 problems): even problems pair
    related sides (b is a repeated to lb, with 15% substitutions), odd ones
    unrelated sides; 1% of a's codes are ambiguity codes."""
    side_b = side if side_b is None else side_b
    if lens is None:
        la = rng.integers(1, side + 1, size=B).astype(np.int32)
        lb = rng.integers(1, side_b + 1, size=B).astype(np.int32)
        edges = [(1, 1), (0, min(5, side_b)), (min(7, side), 0), (0, 0), (side, side_b)]
        for k, (x, y) in enumerate(edges[: B // 2]):
            la[k], lb[k] = x, y
    else:
        la, lb = (np.asarray(x, np.int32).copy() for x in lens)
    a = rng.integers(0, 4, size=(B, side), dtype=np.uint8)
    related = (np.arange(B) % 2 == 0) & (la > 0)
    cols = np.arange(side_b)[None, :]
    b = np.where(related[:, None],
                 np.take_along_axis(a, cols % np.maximum(la, 1)[:, None], axis=1),
                 rng.integers(0, 4, size=(B, side_b), dtype=np.uint8))
    sub = (rng.random((B, side_b)) < 0.15) & (np.arange(B) % 2 == 0)[:, None]
    b[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
    a[rng.random((B, side)) < 0.01] = 4  # a few ambiguity codes
    ca = np.where(np.arange(side)[None, :] < la[:, None], a, 255).astype(np.uint8)
    cb = np.where(cols < lb[:, None], b, 255).astype(np.uint8)
    return ca, cb, la, lb


def count_profiles(rng, codes, lens):
    """uint8 count profiles [B, L, 5] of `codes` [B, L] (lengths `lens`),
    zero rows past each length, drawn for many problems at once (about 4 M
    cells a step): 1-9 rows per problem, each a copy of the codes with 10%
    of its cells redrawn from the four bases, N and a gap (gap cells not
    counted)."""
    B, L = codes.shape
    out = np.zeros((B, L, 5), np.uint8)
    lens = np.asarray(lens, np.int64)
    chunk = max(1, (1 << 22) // (9 * max(L, 1)))
    for lo in range(0, B, chunk):
        c = codes[lo:lo + chunk]
        n = len(c)
        rows = rng.integers(1, 10, size=n)
        cc = np.repeat(c[:, None, :], 9, axis=1)
        mut = rng.random((n, 9, L)) < 0.1
        cc[mut] = rng.integers(0, 6, size=int(mut.sum()), dtype=np.uint8)
        live = ((np.arange(9)[None, :, None] < rows[:, None, None])
                & (np.arange(L)[None, None, :] < lens[lo:lo + chunk, None, None]))
        for lane in range(5):
            out[lo:lo + chunk, :, lane] = ((cc == lane) & live).sum(axis=1)
    return out


def random_profile_batch(rng, B: int, side: int, lens=None, side_b=None):
    """Count profiles (count_profiles) of random_batch's code pairs, with
    its lengths and pairing."""
    ca, cb, la, lb = random_batch(rng, B, side, lens, side_b)
    return count_profiles(rng, ca, la), count_profiles(rng, cb, lb), la, lb


def forward_bound(kernel: str, la, lb):
    """(ms, "bytes" or "operations") the card needs at least for one
    forward launch of these lengths: the live rows read once, the lengths
    read and the score written, one decision byte per live cell."""
    la = np.asarray(la, np.int64)
    lb = np.asarray(lb, np.int64)
    cells = float(((la + 1) * (lb + 1)).sum())
    nbytes = float((la + lb).sum()) * ROW_BYTES[kernel] + 12.0 * len(la) + cells
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = cells * OPS_PER_CELL[kernel] / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def traceback_bound(steps, M: int, N: int):
    """(ms, "bytes") for one traceback launch whose walks take `steps`
    steps (its counts): one decision byte read per step, the lengths read,
    the [B, M+N] op rows and the counts written."""
    steps = np.asarray(steps, np.int64)
    nbytes = float(steps.sum()) + float(len(steps)) * (M + N + 12)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def traceback_chain_floor(steps, sm_mhz: float) -> float:
    """ms that the longest walk of a launch needs at TB_CYCLES_PER_STEP
    cycles a dependent step and an SM clock of sm_mhz."""
    longest = int(np.max(steps)) if len(steps) else 0
    return longest * TB_CYCLES_PER_STEP / (sm_mhz * 1e3)


def device_inputs(rng, shape: dict, dev):
    """Random contents at one recorded launch's lengths, on `dev`."""
    lens = (shape["lens_a"], shape["lens_b"])
    B, M, N = int(shape["B"]), int(shape["M"]), int(shape["N"])
    if shape["kernel"] == "gotoh_forward_codes":
        arrs = random_batch(rng, B, M, lens, N)
        return [torch.from_numpy(x).to(dev) for x in arrs]
    pa, pb, la, lb = random_profile_batch(rng, B, M, lens, N)
    return [torch.from_numpy(pa).to(dev).to(torch.float32),
            torch.from_numpy(pb).to(dev).to(torch.float32),
            torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev)]


def replay(shapes, gotoh_cuda, dev, seed: int = 2026, reps: int = 3, warps: int = 0,
           per_block: int = 0, sm_mhz: float = 0.0):
    """Replay every recorded launch: per kernel name, the summed ms, summed
    bound ms, launches and the bound's kind (the traceback adds its summed
    chain floor and its summed ms right after the forward launch); plus per
    (kernel, side) sums under "by_side".  warps > 0 forces the forward
    kernels' warps per problem, per_block > 0 the traceback's problems a
    block (through the library, this checkout's kernels only)."""
    from mauvealigner_tpu_torch.ops import dp

    sm_mhz = sm_mhz or sm_clock_mhz()
    rng = np.random.default_rng(seed)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    go, ge = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
    out = {}
    by_side = {}

    def add(name, side, B, ms, bound, kind, **extra):
        r = out.setdefault(name, {"ms": 0.0, "bound_ms": 0.0, "launches": 0, "bound_by": set()})
        s = by_side.setdefault((name, side), {"ms": 0.0, "bound_ms": 0.0, "launches": 0,
                                              "problems": 0})
        for row in (r, s):
            row["ms"] += ms
            row["bound_ms"] += bound
            row["launches"] += 1
            for k, v in extra.items():
                row[k] = row.get(k, 0.0) + v
        r["bound_by"].add(kind)
        s["problems"] += B

    for shape in shapes:
        name = shape["kernel"]
        M, N, B = int(shape["M"]), int(shape["N"]), int(shape["B"])
        x = device_inputs(rng, shape, dev)
        la, lb = x[2], x[3]
        if warps:
            fwd = _forced_forward(name, x, sub, go, ge, bool(shape["normalize"]), warps, dev)
        elif name == "gotoh_forward_codes":
            fwd = lambda: gotoh_cuda.gotoh_forward_codes(*x, sub, go, ge)  # noqa: E731
        else:
            norm = bool(shape["normalize"])
            fwd = lambda: gotoh_cuda.gotoh_forward_profiles(*x, sub, go, ge, norm)  # noqa: E731
        if per_block:
            tb = lambda d: _forced_traceback(d, la, lb, per_block, dev)  # noqa: E731
        else:
            tb = lambda d: gotoh_cuda.gotoh_traceback(d, la, lb)  # noqa: E731
        add(name, M, B, cuda_ms(fwd, reps), *forward_bound(name, shape["lens_a"], shape["lens_b"]))
        _, dec = fwd()
        steps = tb(dec)[1].cpu().numpy()
        add("gotoh_traceback", M, B, cuda_ms(lambda: tb(dec), reps), *traceback_bound(steps, M, N),
            chain_floor_ms=traceback_chain_floor(steps, sm_mhz),
            after_forward_ms=cuda_ms_after(lambda: fwd()[1], tb, reps))
        del dec
    for r in out.values():
        r["bound_by"] = "/".join(sorted(r["bound_by"]))
    out["by_side"] = by_side
    out["sm_mhz"] = sm_mhz
    return out


def _forced_traceback(dec, la, lb, per_block, dev):
    import ctypes

    from mauvealigner_tpu_torch.ops import _build

    B, n_diags, W = dec.shape
    M, N = W - 1, n_diags - W
    ops = torch.empty((B, M + N), dtype=torch.uint8, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = _build.library().gotoh_traceback_launch(
        p(dec), p(la), p(lb), B, M, N, per_block, p(ops), p(counts),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"traceback launch with {per_block} problems a block failed: CUDA error {err}")
    return ops, counts


def _forced_forward(name, x, sub, go, ge, normalize, warps, dev):
    import ctypes

    from mauvealigner_tpu_torch.ops import _build, dp

    lib = _build.library()
    go_ge, gev = dp.gap_scalars(go, ge)
    B, M = x[0].shape[:2]
    N = x[1].shape[1]
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    dec = torch.empty((B, M + N + 1, M + 1), dtype=torch.uint8, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    slab = _forced_slab(lib, name, B, N, dev)
    scratch = None if slab is None else p(slab)

    def fwd():
        if name == "gotoh_forward_codes":
            err = lib.gotoh_forward_codes_launch(
                *(p(t) for t in x), p(sub), go_ge, gev, B, M, N, warps, 0, scratch, p(scores),
                p(dec), stream)
        else:
            err = lib.gotoh_forward_profiles_launch(
                *(p(t) for t in x), p(sub), go_ge, gev, B, M, N, int(normalize), warps, 0,
                scratch, p(scores), p(dec), stream)
        if err:
            raise RuntimeError(f"{name} launch with {warps} warps failed: CUDA error {err}")
        return scores, dec

    return fwd


def _forced_slab(lib, name, B, N, dev):
    """The device slab a forced launch needs above shared memory, or None."""
    nbytes = lib.gotoh_forward_scratch_bytes(B, N, int(name == "gotoh_forward_profiles"), 0)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None


def time_sides(gotoh_cuda, dev, per_block: int, sm_mhz: float, label: str, card: str) -> None:
    """The traceback at sides 256 and 4096 (the code kernel's decisions of
    random_batch draws, seed 2024): repeated and after-forward ms, bound,
    chain floor."""
    from mauvealigner_tpu_torch.ops import dp

    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    for side, B in ((256, 64), (4096, 10)):
        rng = np.random.default_rng(2024)
        x = [torch.from_numpy(a).to(dev) for a in random_batch(rng, B, side)]
        fwd = lambda: gotoh_cuda.gotoh_forward_codes(*x, sub, dp.DEFAULT_GAP_OPEN,  # noqa: E731
                                                     dp.DEFAULT_GAP_EXTEND)[1]
        if per_block:
            tb = lambda d: _forced_traceback(d, x[2], x[3], per_block, dev)  # noqa: E731
        else:
            tb = lambda d: gotoh_cuda.gotoh_traceback(d, x[2], x[3])  # noqa: E731
        dec = fwd()
        steps = tb(dec)[1].cpu().numpy()
        ms = cuda_ms(lambda: tb(dec), 20 if side <= 512 else 5)
        after = cuda_ms_after(fwd, tb, 3)
        bound = traceback_bound(steps, side, side)[0]
        floor = traceback_chain_floor(steps, sm_mhz)
        print(f"{label} gotoh_traceback side {side} B={B}: {ms:.4f} ms, after forward "
              f"{after:.4f} ms, bound {bound:.6f} ms (bytes), roofline share {bound / ms:.4f}, "
              f"chain floor {floor:.4f} ms (longest walk {int(steps.max())} steps x "
              f"{TB_CYCLES_PER_STEP} cycles at {sm_mhz:.0f} MHz), {ms / floor:.2f}x the floor, "
              f"{ms * 1e6 / int(steps.max()):.1f} ns a step of the longest walk ({card})",
              flush=True)


def save_shapes(path: str, shapes) -> None:
    flat = {}
    for k, s in enumerate(shapes):
        for key in ("kernel", "M", "N", "B", "normalize", "lens_a", "lens_b"):
            flat[f"{k}_{key}"] = np.asarray(s[key])
    flat["count"] = np.asarray(len(shapes))
    np.savez_compressed(path, **flat)


def load_shapes(path: str):
    z = np.load(path)
    keys = ("kernel", "M", "N", "B", "normalize", "lens_a", "lens_b")
    out = []
    for k in range(int(z["count"])):
        s = {key: z[f"{k}_{key}"] for key in keys}
        s["kernel"] = str(s["kernel"])
        out.append(s)
    return out


def _chain(r: dict) -> str:
    """The traceback's extra numbers on a replay line."""
    if "chain_floor_ms" not in r:
        return ""
    return (f", chain floor {r['chain_floor_ms']:.4f} ms ({TB_CYCLES_PER_STEP} cycles a step "
            f"assumed), after forward {r['after_forward_ms']:.4f} ms")


def print_replay(label: str, res: dict, card: str) -> None:
    for name in ("gotoh_forward_codes", "gotoh_forward_profiles", "gotoh_traceback"):
        r = res.get(name)
        if r is None:
            continue
        share = r["bound_ms"] / r["ms"] if r["ms"] else float("nan")
        print(f"{label} {name}: {r['launches']} launches, {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}), roofline share {share:.4f}{_chain(r)} "
              f"({card}, max SM clock {res['sm_mhz']:.0f} MHz)", flush=True)
    for (name, side), s in sorted(res["by_side"].items()):
        print(f"{label}   {name} side {side}: {s['launches']} launches, {s['problems']} problems, "
              f"{s['ms']:.4f} ms, bound {s['bound_ms']:.6f} ms{_chain(s)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["record", "replay", "sides"])
    ap.add_argument("path", nargs="?", default="")
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--warps", type=int, nargs="*", default=[0])
    ap.add_argument("--per-block", type=int, nargs="*", default=[0])
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    if not torch.cuda.is_available():
        print("gotoh_replay: torch sees no CUDA device", file=sys.stderr)
        return 1
    from mauvealigner_tpu_torch.ops import gotoh_cuda

    dev = torch.device("cuda", 0)
    card = card_line()
    if a.mode == "record":
        from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
        from mauvealigner_tpu_torch.utils import simulate

        rng = np.random.default_rng(37)
        anc = simulate.random_genome(rng, 250_000)
        genomes = [anc] + [simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001,
                                           del_rate=0.001)[0] for _ in range(8)]
        gotoh_cuda.reset_launches()
        ProgressiveMauve(ProgressiveOptions(device="cuda")).align(genomes)
        torch.cuda.synchronize()
        save_shapes(a.path, gotoh_cuda.LAUNCH_SHAPES)
        print(f"recorded {len(gotoh_cuda.LAUNCH_SHAPES)} launches of config 3 into {a.path}")
        return 0
    print(card, flush=True)
    label = a.label or os.path.basename(os.path.abspath(a.root))
    sm_mhz = sm_clock_mhz()
    if a.mode == "sides":
        for pb in a.per_block:
            time_sides(gotoh_cuda, dev, pb, sm_mhz, f"[{label} per_block={pb or 'default'}]", card)
        return 0
    shapes = load_shapes(a.path)
    for w in a.warps:
        for pb in a.per_block:
            res = replay(shapes, gotoh_cuda, dev, warps=w, per_block=pb, sm_mhz=sm_mhz)
            print_replay(f"[{label} warps={w or 'default'} per_block={pb or 'default'}]", res, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
