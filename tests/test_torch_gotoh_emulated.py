"""The CUDA kernels' own source (csrc/gotoh.cu), run on the CPU.

The kernels cannot run here, but their schedules can: g++ compiles
csrc/gotoh.cu against tests/cuda_cpu_emulation.h, which stands in for the
few CUDA features the file uses (one thread per CUDA thread, barriers for
__syncthreads, __syncwarp and __shfl_up_sync, plain copies for the
traceback's reads of dec).  Each forward launch is held to the plain-torch
version on the same inputs: scores exact, every byte of each problem's live
rectangle (dp.live_cell_mask) identical, and every byte outside it left as
it was.  Each traceback launch is held to dp.gotoh_traceback_ref on ops and
counts, on the emulated forward kernels' decisions with every dead byte
poisoned and on wholly random bytes, and every byte it reads lies inside
its own problem's slab.  This checks the strip / phase / buffer logic of
every block shape and the traceback's tiles, not the GPU's compiler or
speed (test_torch_gpu.py and chip_smoke.py do that on the card).  A small
shared-memory limit passed to the launchers sends small sides through the
forward kernels' device-slab path, which the card takes above its limit.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mauvealigner_tpu_torch.ops import _build, dp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
UNTOUCHED = 0xEE


def _compile(tmp_path_factory, name: str, edit=lambda src: src):
    """csrc/gotoh.cu built with g++ against the CPU emulation (after
    `edit`), loaded and bound as the CUDA library is."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the CUDA source")
    with open(os.path.join(_build.CSRC, "gotoh.cu")) as fh:
        src = edit(fh.read())
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_cpu_emulation.h"')
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_dynamic_smem();")
    src = src.replace("__shared__ float sub6[36];", "float* sub6 = (float*)emu_static_smem();")
    src, n = re.subn(r"([\w<>]+?)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(",
                     r"EmuLaunch(\2, \3, \4).run(\1, ", src)
    assert n == 3 and "__shared__" not in src
    out = tmp_path_factory.mktemp(name)
    cpp = out / "gotoh_emulated.cpp"
    cpp.write_text(src)
    so = out / "libgotoh_emulated.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-I", HERE, "-o", str(so), str(cpp)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    _build._bind_gotoh(lib)
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.emu_dec_read_range.argtypes = [ctypes.c_void_p, ll, ll]
    lib.emu_dec_read_range.restype = ctypes.c_int
    lib.emu_dec_reads_clear.argtypes = []
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _compile(tmp_path_factory, "gotoh_emulated")


@pytest.fixture(scope="module")
def emulated_wide(tmp_path_factory):
    """The same source with the traceback's 64-bit slab offsets (taken above
    2^31 bytes a slab, side 32768 and up) forced at every size."""
    def wide(src):
        assert src.count("> 0x7fffffffLL") == 1
        return src.replace("> 0x7fffffffLL", ">= 0LL")
    return _compile(tmp_path_factory, "gotoh_emulated_wide", wide)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _inputs(rng, B, M, N):
    """Code pairs with edge lengths (full, empty, one-sided, 1 x 1) first."""
    la = rng.integers(0, M + 1, size=B).astype(np.int32)
    lb = rng.integers(0, N + 1, size=B).astype(np.int32)
    for k, (x, y) in enumerate([(M, N), (0, 0), (0, N), (M, 0), (1, 1)][:B]):
        la[k], lb[k] = x, y
    ca = np.full((B, M), 255, np.uint8)
    cb = np.full((B, N), 255, np.uint8)
    for k in range(B):
        a = rng.integers(0, 5, size=la[k])
        b = np.resize(a, lb[k]) if (k % 2 and la[k]) else rng.integers(0, 4, size=lb[k])
        ca[k, : la[k]] = a
        cb[k, : lb[k]] = np.where(rng.random(lb[k]) < 0.2, rng.integers(0, 5, size=lb[k]), b)
    return ca, cb, la, lb


def _counts(rng, codes, lens):
    """uint8-valued count profiles of 1-5 rows, as f32, zero rows past lens."""
    B, side = codes.shape
    out = np.zeros((B, side, 5), np.float32)
    for k in range(B):
        n = int(lens[k])
        for _ in range(int(rng.integers(1, 6))):
            c = codes[k, :n].astype(np.int64)
            hit = rng.random(n) < 0.15
            c[hit] = rng.integers(0, 6, size=int(hit.sum()))  # 5 = gap
            keep = c < 5
            np.add.at(out[k], (np.arange(n)[keep], c[keep]), 1)
    return out


@pytest.mark.parametrize(
    "kind,M,N,warps,normalize,gaps",
    [
        ("codes", 16, 16, 0, False, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)),
        ("codes", 33, 20, 1, False, (-10.0, -1.0)),
        ("codes", 70, 130, 2, False, (-0.3, -0.7)),
        ("codes", 130, 70, 4, False, (0.0, 0.0)),
        ("codes", 96, 96, 16, False, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)),
        ("profiles", 40, 40, 0, True, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)),
        ("profiles", 100, 100, 3, False, (-1000.0, -100.0)),
        ("profiles", 150, 150, 0, True, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)),
    ],
)
def test_emulated_kernel_matches_plain(emulated, kind, M, N, warps, normalize, gaps):
    _check_forward(emulated, kind, M, N, warps, normalize, gaps, smem_limit=0)


def _launch_forward(lib, kind, arrays, B, M, N, gaps, normalize, warps, smem_limit, scores,
                    dec):
    """One emulated forward launch through the library's own plan: the
    device slab (gotoh_forward_scratch_bytes of it, else none) and the
    shared-memory limit (0: the card's).  Returns the slab's size."""
    go_ge, ge_s = dp.gap_scalars(*gaps)
    sub = dp.HOXD70.copy()
    nbytes = lib.gotoh_forward_scratch_bytes(B, N, int(kind == "profiles"), smem_limit)
    slab = np.full(max(nbytes, 1), 0x5A, np.uint8)
    scratch = _ptr(slab) if nbytes else None
    a, b, la, lb = arrays
    if kind == "codes":
        err = lib.gotoh_forward_codes_launch(
            _ptr(a), _ptr(b), _ptr(la), _ptr(lb), _ptr(sub), go_ge, ge_s, B, M, N, warps,
            smem_limit, scratch, _ptr(scores), _ptr(dec), None)
    else:
        err = lib.gotoh_forward_profiles_launch(
            _ptr(a), _ptr(b), _ptr(la), _ptr(lb), _ptr(sub), go_ge, ge_s, B, M, N,
            int(normalize), warps, smem_limit, scratch, _ptr(scores), _ptr(dec), None)
    assert err == 0
    return nbytes


def _check_forward(lib, kind, M, N, warps, normalize, gaps, smem_limit):
    """Scores exact, the live rectangle byte for byte and every dead byte
    untouched, against the plain version; returns the slab's size."""
    rng = np.random.default_rng(M * 131 + N + warps)
    B = 6
    go, ge = gaps
    ca, cb, la, lb = _inputs(rng, B, M, N)
    sub = torch.from_numpy(dp.HOXD70.copy())
    scores = np.full(B, np.nan, np.float32)
    dec = np.full((B, M + N + 1, M + 1), UNTOUCHED, np.uint8)
    lens = (torch.from_numpy(la), torch.from_numpy(lb))
    if kind == "codes":
        arrays = (ca, cb, la, lb)
        s_p, d_p = dp.gotoh_forward_codes_ref(
            torch.from_numpy(ca), torch.from_numpy(cb), *lens, sub, go, ge)
    else:
        pa, pb = _counts(rng, ca, la), _counts(rng, cb, lb)
        arrays = (pa, pb, la, lb)
        s_p, d_p = dp.gotoh_forward_profiles_ref(
            torch.from_numpy(pa), torch.from_numpy(pb), *lens, sub, go, ge, normalize)
    nbytes = _launch_forward(lib, kind, arrays, B, M, N, gaps, normalize, warps, smem_limit,
                             scores, dec)
    live = dp.live_cell_mask(*lens, M, N).numpy()
    assert np.array_equal(scores, s_p.numpy())
    assert np.array_equal(dec[live], d_p.numpy()[live])
    assert (dec[~live] == UNTOUCHED).all()
    return nbytes


@pytest.mark.parametrize(
    "kind,M,N,warps,normalize",
    [
        ("codes", 64, 64, 0, False),
        ("codes", 20, 300, 0, False),     # one warp a problem, several problems a block
        ("codes", 256, 200, 2, False),
        ("codes", 512, 512, 0, False),
        ("profiles", 64, 64, 1, True),
        ("profiles", 128, 256, 0, False),
        ("profiles", 512, 512, 0, False),
        ("profiles", 300, 300, 16, True),
    ],
)
def test_emulated_device_slab_matches_plain(emulated, kind, M, N, warps, normalize):
    """A shared-memory limit below one problem's buffer sends the launch
    through the device slab (the card's path above side 8192 for codes and
    4096 for profiles): the same bytes and scores as the plain version."""
    gaps = (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)
    assert _check_forward(emulated, kind, M, N, warps, normalize, gaps, smem_limit=1024) > 0


def test_emulated_launch_plan(emulated):
    """The card's limit keeps codes in shared memory up to side 8192 and
    profiles up to 4096; above, the slab is a problem_bytes row a problem."""
    plan = emulated.gotoh_forward_scratch_bytes
    assert plan(3, 8192, 0, 0) == 0 and plan(3, 4096, 1, 0) == 0
    assert plan(3, 16384, 0, 0) == 3 * (16 * (16384 + 33) + 16384 + 64)
    assert plan(2, 8192, 1, 0) == 2 * (16 * (8192 + 33) + 20 * (8192 + 64))
    assert plan(5, 64, 0, 64) == 5 * (16 * 97 + 128)


def _emulated_forward(lib, kind, M, N, gaps, normalize, fill, rng, B):
    """Decisions of the emulated forward kernel on fresh inputs, every byte
    outside the live rectangles set by `fill` first (the kernel leaves them
    as they are); returns (dec, dec of the plain version, la, lb)."""
    go, ge = gaps
    ca, cb, la, lb = _inputs(rng, B, M, N)
    sub = torch.from_numpy(dp.HOXD70.copy())
    scores = np.zeros(B, np.float32)
    dec = fill((B, M + N + 1, M + 1))
    lens = (torch.from_numpy(la), torch.from_numpy(lb))
    if kind == "codes":
        arrays = (ca, cb, la, lb)
        _, d_p = dp.gotoh_forward_codes_ref(
            torch.from_numpy(ca), torch.from_numpy(cb), *lens, sub, go, ge)
    else:
        pa, pb = _counts(rng, ca, la), _counts(rng, cb, lb)
        arrays = (pa, pb, la, lb)
        _, d_p = dp.gotoh_forward_profiles_ref(
            torch.from_numpy(pa), torch.from_numpy(pb), *lens, sub, go, ge, normalize)
    _launch_forward(lib, kind, arrays, B, M, N, gaps, normalize, 0, 0, scores, dec)
    return dec, d_p, la, lb


def _emulated_traceback(lib, dec, la, lb, per_block):
    """The emulated traceback kernel's (ops, counts); asserts that every
    byte it read lies inside the slab of the problem it walked."""
    B, n_diags, W = dec.shape
    M, N = W - 1, n_diags - W
    ops = np.full((B, M + N), 0x77, np.uint8)
    counts = np.full(B, -1, np.int32)
    lib.emu_dec_reads_clear()
    err = lib.gotoh_traceback_launch(
        _ptr(dec), _ptr(la), _ptr(lb), B, M, N, per_block, _ptr(ops), _ptr(counts), None)
    assert err == 0
    n = n_diags * W
    lo, hi = ctypes.c_longlong(), ctypes.c_longlong()
    for b in range(B):
        slab = ctypes.c_void_p(dec.ctypes.data + b * n)
        if lib.emu_dec_read_range(slab, ctypes.byref(lo), ctypes.byref(hi)):
            assert 0 <= lo.value <= hi.value < n, (b, lo.value, hi.value, n)
        else:
            assert la[b] == 0 and lb[b] == 0, b  # only an empty walk reads nothing
    return ops, counts


def _poison(value):
    def fill(shape):
        if value == "random":
            return np.random.default_rng(sum(shape)).integers(0, 256, size=shape, dtype=np.uint8)
        return np.full(shape, value, np.uint8)
    return fill


@pytest.mark.parametrize(
    "kind,M,N,gaps,normalize,poison,B,per_block",
    [
        ("codes", 16, 16, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND), False, UNTOUCHED, 6, 0),
        ("codes", 33, 20, (-10.0, -1.0), False, "random", 10, 4),
        ("codes", 70, 130, (-0.3, -0.7), False, UNTOUCHED, 7, 3),
        ("codes", 130, 70, (0.0, 0.0), False, "random", 9, 7),
        ("profiles", 40, 40, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND), True, UNTOUCHED, 6, 2),
        ("profiles", 100, 100, (-1000.0, -100.0), False, "random", 8, 0),
        # walks over several tiles of 65 rows and 130 diagonals
        ("codes", 300, 260, (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND), False, "random", 7, 3),
        ("codes", 180, 420, (-10.0, -1.0), False, UNTOUCHED, 5, 0),
    ],
)
def test_emulated_traceback_matches_plain(emulated, kind, M, N, gaps, normalize, poison, B,
                                          per_block):
    """The traceback of the emulated forward kernel's decisions, every dead
    byte poisoned, equals the plain traceback of the plain decisions."""
    rng = np.random.default_rng(M * 7 + N + B)
    dec, d_p, la, lb = _emulated_forward(emulated, kind, M, N, gaps, normalize,
                                         _poison(poison), rng, B)
    ops, counts = _emulated_traceback(emulated, dec, la, lb, per_block)
    o_p, c_p = dp.gotoh_traceback_ref(d_p, torch.from_numpy(la), torch.from_numpy(lb))
    assert np.array_equal(counts, c_p.numpy())
    assert np.array_equal(ops, o_p.numpy())
    assert (counts[1] == 0) and not ops[1].any()  # (0, 0): no step, all OP_NONE


@pytest.mark.parametrize(
    "M,N,B,per_block",
    [(40, 25, 9, 0), (25, 40, 9, 5), (0, 7, 3, 0), (9, 0, 3, 2), (150, 150, 4, 1)],
)
def test_emulated_traceback_on_random_bytes(emulated, M, N, B, per_block):
    """Wholly random decision bytes lead walks out of the rectangle, through
    clamped indices, until L = M+N steps: the kernel still equals the plain
    version and reads nothing outside each problem's slab."""
    rng = np.random.default_rng(M * 31 + N)
    dec = rng.integers(0, 256, size=(B, M + N + 1, M + 1), dtype=np.uint8)
    la = rng.integers(0, M + 1, size=B).astype(np.int32)
    lb = rng.integers(0, N + 1, size=B).astype(np.int32)
    la[0], lb[0] = M, N
    ops, counts = _emulated_traceback(emulated, dec, la, lb, per_block)
    o_p, c_p = dp.gotoh_traceback_ref(
        torch.from_numpy(dec), torch.from_numpy(la), torch.from_numpy(lb))
    assert np.array_equal(counts, c_p.numpy())
    assert np.array_equal(ops, o_p.numpy())


@pytest.mark.parametrize("M,N,B,per_block", [(40, 25, 9, 0), (150, 150, 4, 1), (300, 260, 7, 3)])
def test_emulated_traceback_wide_offsets(emulated_wide, M, N, B, per_block):
    """The traceback instance with 64-bit slab offsets, on random bytes and
    on the forward kernel's poisoned decisions: the plain version's ops and
    counts, reads inside each slab."""
    rng = np.random.default_rng(M * 13 + N)
    dec = rng.integers(0, 256, size=(B, M + N + 1, M + 1), dtype=np.uint8)
    la = rng.integers(0, M + 1, size=B).astype(np.int32)
    lb = rng.integers(0, N + 1, size=B).astype(np.int32)
    la[0], lb[0] = M, N
    ops, counts = _emulated_traceback(emulated_wide, dec, la, lb, per_block)
    o_p, c_p = dp.gotoh_traceback_ref(
        torch.from_numpy(dec), torch.from_numpy(la), torch.from_numpy(lb))
    assert np.array_equal(counts, c_p.numpy()) and np.array_equal(ops, o_p.numpy())
    gaps = (dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)
    dec, d_p, la, lb = _emulated_forward(emulated_wide, "codes", M, N, gaps, False,
                                         _poison(UNTOUCHED), rng, B)
    ops, counts = _emulated_traceback(emulated_wide, dec, la, lb, per_block)
    o_p, c_p = dp.gotoh_traceback_ref(d_p, torch.from_numpy(la), torch.from_numpy(lb))
    assert np.array_equal(counts, c_p.numpy()) and np.array_equal(ops, o_p.numpy())
