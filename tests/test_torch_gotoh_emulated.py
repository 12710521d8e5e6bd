"""The CUDA forward kernels' own source (csrc/gotoh.cu), run on the CPU.

The kernels cannot run here, but their schedule can: g++ compiles
csrc/gotoh.cu against tests/cuda_cpu_emulation.h, which stands in for the
few CUDA features the file uses (one thread per CUDA thread, barriers for
__syncthreads, __syncwarp and __shfl_up_sync).  Each launch is held to the
plain-torch version on the same inputs: scores exact, every byte of each
problem's live rectangle (dp.live_cell_mask) identical, and every byte
outside it left as it was.  This checks the strip / phase / buffer logic of
every block shape, not the GPU's compiler or speed (test_torch_gpu.py and
chip_smoke.py do that on the card).
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the CUDA source")
    with open(os.path.join(_build.CSRC, "gotoh.cu")) as fh:
        src = fh.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_cpu_emulation.h"')
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_dynamic_smem();")
    src = src.replace("__shared__ float sub6[36];", "float* sub6 = (float*)emu_static_smem();")
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(",
                     r"EmuLaunch(\2, \3, \4).run(\1, ", src)
    assert n == 3 and "__shared__" not in src
    out = tmp_path_factory.mktemp("gotoh_emulated")
    cpp = out / "gotoh_emulated.cpp"
    cpp.write_text(src)
    so = out / "libgotoh_emulated.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-I", HERE, "-o", str(so), str(cpp)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    _build._bind(lib)
    return lib


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
    rng = np.random.default_rng(M * 131 + N + warps)
    B = 6
    go, ge = gaps
    ca, cb, la, lb = _inputs(rng, B, M, N)
    sub = dp.HOXD70.copy()
    go_ge, ge_s = dp.gap_scalars(go, ge)
    scores = np.full(B, np.nan, np.float32)
    dec = np.full((B, M + N + 1, M + 1), UNTOUCHED, np.uint8)
    lens = (torch.from_numpy(la), torch.from_numpy(lb))
    if kind == "codes":
        err = emulated.gotoh_forward_codes_launch(
            _ptr(ca), _ptr(cb), _ptr(la), _ptr(lb), _ptr(sub), go_ge, ge_s, B, M, N, warps,
            _ptr(scores), _ptr(dec), None)
        s_p, d_p = dp.gotoh_forward_codes_ref(
            torch.from_numpy(ca), torch.from_numpy(cb), *lens, torch.from_numpy(sub), go, ge)
    else:
        pa, pb = _counts(rng, ca, la), _counts(rng, cb, lb)
        err = emulated.gotoh_forward_profiles_launch(
            _ptr(pa), _ptr(pb), _ptr(la), _ptr(lb), _ptr(sub), go_ge, ge_s, B, M, N,
            int(normalize), warps, _ptr(scores), _ptr(dec), None)
        s_p, d_p = dp.gotoh_forward_profiles_ref(
            torch.from_numpy(pa), torch.from_numpy(pb), *lens, torch.from_numpy(sub), go, ge,
            normalize)
    assert err == 0
    live = dp.live_cell_mask(*lens, M, N).numpy()
    assert np.array_equal(scores, s_p.numpy())
    assert np.array_equal(dec[live], d_p.numpy()[live])
    assert (dec[~live] == UNTOUCHED).all()
