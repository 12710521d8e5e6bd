"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

nvcc compiles the sources into one shared library with a plain C interface
(-gencode arch=compute_90a,code=sm_90a), written to the git-ignored
build/kernels/ directory under a name keyed by a hash of the sources and
flags, and loaded with ctypes.  Only sources inside the package are built.
The wrappers (ops/gotoh_cuda.py, ops/extend_cuda.py) share the helpers at
the end: input checks, pointers, the current stream and launch errors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, library path, nvcc's
# output (-Xptxas -v: registers, shared memory and spills per kernel)
build_info: dict = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"mauve_kernels_{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    build_info.update(
        seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr
    )


def _bind(lib: ctypes.CDLL) -> None:
    _bind_gotoh(lib)
    _bind_extend(lib)


def _bind_gotoh(lib: ctypes.CDLL) -> None:
    """Declare csrc/gotoh.cu's C functions."""
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.gotoh_forward_scratch_bytes.argtypes = [I, I, I, LL]
    lib.gotoh_forward_scratch_bytes.restype = LL
    lib.gotoh_forward_codes_launch.argtypes = [P, P, P, P, P, F, F, I, I, I, I, LL, P, P, P, P]
    lib.gotoh_forward_codes_launch.restype = I
    lib.gotoh_forward_profiles_launch.argtypes = [P, P, P, P, P, F, F, I, I, I, I, I, LL, P, P,
                                                  P, P]
    lib.gotoh_forward_profiles_launch.restype = I
    lib.gotoh_traceback_launch.argtypes = [P, P, P, I, I, I, I, P, P, P]
    lib.gotoh_traceback_launch.restype = I
    lib.gotoh_error_string.argtypes = [I]
    lib.gotoh_error_string.restype = ctypes.c_char_p


def _bind_extend(lib: ctypes.CDLL) -> None:
    """Declare csrc/extend.cu's C function."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.extend_matches_launch.argtypes = [P, P, P, P, LL, I, P, P, P]
    lib.extend_matches_launch.restype = I


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            so = _library_path()
            if not os.path.exists(so):
                _compile(so)
            build_info["path"] = so
            lib = ctypes.CDLL(so)
            _bind(lib)
            _lib = lib
    return _lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """The current CUDA stream of `dev`, which every launcher takes."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a launcher's nonzero return (its cudaGetLastError())."""
    if err != 0:
        msg = lib.gotoh_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
