"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

nvcc compiles the sources into one shared library with a plain C interface
(-gencode arch=compute_90a,code=sm_90a), written to the git-ignored
build/kernels/ directory under a name keyed by a hash of the sources and
flags, and loaded with ctypes.  Only sources inside the package are built.
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
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gotoh_forward_codes_launch.argtypes = [P, P, P, P, P, F, F, I, I, I, I, P, P, P]
    lib.gotoh_forward_codes_launch.restype = I
    lib.gotoh_forward_profiles_launch.argtypes = [P, P, P, P, P, F, F, I, I, I, I, I, P, P, P]
    lib.gotoh_forward_profiles_launch.restype = I
    lib.gotoh_traceback_launch.argtypes = [P, P, P, I, I, I, P, P, P]
    lib.gotoh_traceback_launch.restype = I
    lib.gotoh_error_string.argtypes = [I]
    lib.gotoh_error_string.restype = ctypes.c_char_p


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
