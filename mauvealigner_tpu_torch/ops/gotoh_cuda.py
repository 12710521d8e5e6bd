"""K3 kernels: the hand-written CUDA Gotoh forward pass and traceback.

gotoh_forward_codes (code pairs) and gotoh_forward_profiles (count
profiles, optionally normalized) replace the two input modes of the TPU
kernel mauvealigner_tpu/ops/dp_pallas.py::_kernel / gotoh_forward_pallas;
gotoh_traceback replaces the XLA mauvealigner_tpu/ops/dp.py::gotoh_traceback
and serves both.
The sources are csrc/gotoh.cu (design and bounds noted there), built by
ops/_build.py on first use.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain-torch version in ops/dp.py.  LAUNCHES counts the kernel launches
of each wrapper (plain-version calls are not counted).  LAUNCH_SHAPES lists
the shape of every forward launch of dp.align_*_batch_async (one per mesh
shard under a mesh), made from the lengths they hold on the host: a
replayable record of a run's launches.  Both are updated under one lock
(count_launch, record_shape): the tree ladder's pool launches from several
threads.  Each launch runs with its inputs'
device made current, so a mesh shard on another card launches there.

The forward kernels write only the live rectangle of each problem
(dp.live_cell_mask); the other bytes of `dec` are left as torch.empty gives
them.  Any side runs: where a problem's row buffers and staged B side do
not fit a block's shared memory (codes above side 8192, profiles above
4096 on an H100), the wrapper allocates a device slab for them
(gotoh_forward_scratch_bytes) and the same kernel keeps them there.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from mauvealigner_tpu_torch.ops import _build, dp
from mauvealigner_tpu_torch.ops._build import check_tensor, ptr, raise_on_error, stream

LAUNCHES = {"gotoh_forward_codes": 0, "gotoh_forward_profiles": 0, "gotoh_traceback": 0}
# one dict per forward call of dp.align_*_batch_async: kernel, M, N, B,
# lens_a, lens_b (host int32 arrays) and normalize
LAUNCH_SHAPES: list = []
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LAUNCH_SHAPES.clear()


def count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def record_shape(**shape) -> None:
    """Append one forward call's shape (kernel, M, N, B, lens_a, lens_b,
    normalize) to LAUNCH_SHAPES."""
    with _launch_lock:
        LAUNCH_SHAPES.append(shape)


def _kernel_gaps(gap_open: float, gap_extend: float) -> Tuple[float, float]:
    """(go_ge, ge) for a kernel launch.  The kernels take gap scores <= 0:
    only then do the cells left of column 0 hold the NEG sentinels that the
    kernels' column-0 bytes assume (csrc/gotoh.cu)."""
    go_ge, ge = dp.gap_scalars(gap_open, gap_extend)
    if go_ge > 0 or ge > 0:
        raise ValueError(
            f"the CUDA Gotoh kernels take gap scores <= 0, got gap_open={gap_open}, "
            f"gap_extend={gap_extend}"
        )
    return go_ge, ge


def _slab(lib, B: int, N: int, profiles: bool, dev):
    """(the device slab a forward launch needs, its pointer), or (None, a
    null pointer) when the problems fit shared memory."""
    nbytes = lib.gotoh_forward_scratch_bytes(B, N, int(profiles), 0)
    if not nbytes:
        return None, ctypes.c_void_p(None)
    slab = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return slab, ptr(slab)


def gotoh_forward_codes(
    codes_a: torch.Tensor,  # uint8 [B, M], codes > 4 are padding
    codes_b: torch.Tensor,  # uint8 [B, N]
    lens_a: torch.Tensor,   # int32 [B], each <= M
    lens_b: torch.Tensor,   # int32 [B], each <= N
    subst: torch.Tensor,    # f32 [5, 5]
    gap_open: float,
    gap_extend: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Gotoh forward pass: (scores [B] f32, dec [B, M+N+1, M+1]
    uint8), as dp.gotoh_forward_codes_ref computes them."""
    if codes_a.device.type == "cpu":
        return dp.gotoh_forward_codes_ref(
            codes_a, codes_b, lens_a, lens_b, subst, gap_open, gap_extend
        )
    if codes_a.device.type != "cuda":
        raise ValueError(f"no Gotoh kernel for device {codes_a.device}")
    return _forward_codes_launch(codes_a, codes_b, lens_a, lens_b, subst, gap_open, gap_extend)


def _forward_codes_launch(codes_a, codes_b, lens_a, lens_b, subst, gap_open, gap_extend):
    """The CUDA half of gotoh_forward_codes: checks, allocation and the
    launch, on the inputs' device made current (the runtime launches on the
    current device, and a mesh shard may live on another card)."""
    B, M = codes_a.shape
    N = codes_b.shape[1]
    dev = codes_a.device
    check_tensor(codes_a, "codes_a", torch.uint8, (B, M), dev)
    check_tensor(codes_b, "codes_b", torch.uint8, (B, N), dev)
    check_tensor(lens_a, "lens_a", torch.int32, (B,), dev)
    check_tensor(lens_b, "lens_b", torch.int32, (B,), dev)
    check_tensor(subst, "subst", torch.float32, (5, 5), dev)
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    dec = torch.empty((B, M + N + 1, M + 1), dtype=torch.uint8, device=dev)
    if B == 0:
        return scores, dec
    lib = _build.library()
    go_ge, ge = _kernel_gaps(gap_open, gap_extend)
    with torch.cuda.device(dev):
        slab, slab_ptr = _slab(lib, B, N, False, dev)  # held until the launch is queued
        err = lib.gotoh_forward_codes_launch(
            ptr(codes_a), ptr(codes_b), ptr(lens_a), ptr(lens_b), ptr(subst),
            go_ge, ge, B, M, N, 0, 0, slab_ptr, ptr(scores), ptr(dec), stream(dev),
        )
    raise_on_error(lib, err, "gotoh_forward_codes")
    count_launch("gotoh_forward_codes")
    return scores, dec


def gotoh_forward_profiles(
    prof_a: torch.Tensor,  # f32 [B, M, 5], zero rows past lens_a
    prof_b: torch.Tensor,  # f32 [B, N, 5]
    lens_a: torch.Tensor,  # int32 [B], each <= M
    lens_b: torch.Tensor,  # int32 [B], each <= N
    subst: torch.Tensor,   # f32 [5, 5]
    gap_open: float,
    gap_extend: float,
    normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Gotoh forward pass over profiles: (scores [B] f32,
    dec [B, M+N+1, M+1] uint8), as dp.gotoh_forward_profiles_ref computes
    them."""
    if prof_a.device.type == "cpu":
        return dp.gotoh_forward_profiles_ref(
            prof_a, prof_b, lens_a, lens_b, subst, gap_open, gap_extend, normalize
        )
    if prof_a.device.type != "cuda":
        raise ValueError(f"no Gotoh kernel for device {prof_a.device}")
    return _forward_profiles_launch(
        prof_a, prof_b, lens_a, lens_b, subst, gap_open, gap_extend, normalize
    )


def _forward_profiles_launch(prof_a, prof_b, lens_a, lens_b, subst, gap_open, gap_extend,
                             normalize):
    """The CUDA half of gotoh_forward_profiles, on the inputs' device made
    current."""
    B, M, _ = prof_a.shape
    N = prof_b.shape[1]
    dev = prof_a.device
    check_tensor(prof_a, "prof_a", torch.float32, (B, M, 5), dev)
    check_tensor(prof_b, "prof_b", torch.float32, (B, N, 5), dev)
    check_tensor(lens_a, "lens_a", torch.int32, (B,), dev)
    check_tensor(lens_b, "lens_b", torch.int32, (B,), dev)
    check_tensor(subst, "subst", torch.float32, (5, 5), dev)
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    dec = torch.empty((B, M + N + 1, M + 1), dtype=torch.uint8, device=dev)
    if B == 0:
        return scores, dec
    lib = _build.library()
    go_ge, ge = _kernel_gaps(gap_open, gap_extend)
    with torch.cuda.device(dev):
        slab, slab_ptr = _slab(lib, B, N, True, dev)  # held until the launch is queued
        err = lib.gotoh_forward_profiles_launch(
            ptr(prof_a), ptr(prof_b), ptr(lens_a), ptr(lens_b), ptr(subst),
            go_ge, ge, B, M, N, int(bool(normalize)), 0, 0, slab_ptr, ptr(scores),
            ptr(dec), stream(dev),
        )
    raise_on_error(lib, err, "gotoh_forward_profiles")
    count_launch("gotoh_forward_profiles")
    return scores, dec


def gotoh_traceback(
    dec: torch.Tensor,     # uint8 [B, M+N+1, M+1]
    lens_a: torch.Tensor,  # int32 [B]
    lens_b: torch.Tensor,  # int32 [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traceback of either forward kernel's decisions: (ops [B, M+N] uint8 end
    first, counts [B] int32), as dp.gotoh_traceback_ref computes them."""
    if dec.device.type == "cpu":
        return dp.gotoh_traceback_ref(dec, lens_a, lens_b)
    if dec.device.type != "cuda":
        raise ValueError(f"no traceback kernel for device {dec.device}")
    return _traceback_launch(dec, lens_a, lens_b)


def _traceback_launch(dec, lens_a, lens_b):
    """The CUDA half of gotoh_traceback, on the inputs' device made
    current."""
    B, n_diags, W = dec.shape
    M = W - 1
    N = n_diags - 1 - M
    if N < 0:
        raise ValueError(f"dec shape {tuple(dec.shape)} is not [B, M+N+1, M+1]")
    dev = dec.device
    check_tensor(dec, "dec", torch.uint8, (B, n_diags, W), dev)
    check_tensor(lens_a, "lens_a", torch.int32, (B,), dev)
    check_tensor(lens_b, "lens_b", torch.int32, (B,), dev)
    ops = torch.empty((B, M + N), dtype=torch.uint8, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, counts
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gotoh_traceback_launch(
            ptr(dec), ptr(lens_a), ptr(lens_b), B, M, N, 0, ptr(ops), ptr(counts),
            stream(dev),
        )
    raise_on_error(lib, err, "gotoh_traceback")
    count_launch("gotoh_traceback")
    return ops, counts
