"""Loader for the native host runtime (C++ extension, host-only).

Builds native/mauve_native.cpp (the same source the JAX package loads) with
g++ against the running CPython's headers, into the git-ignored
build/native/ directory, keyed by a hash of the source; the committed
object under native/ is never touched.  Every caller has a pure-NumPy
fallback, so a missing toolchain degrades performance, not correctness.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading
from typing import Optional

_lock = threading.Lock()
_module = None
_tried = False

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_ROOT, "native", "mauve_native.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")


def _so_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD_DIR, f"mauve_native_{digest}{tag}")


def _build() -> Optional[str]:
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    # build under a private name, then rename: concurrent builders (test
    # workers) never load a half-written object
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get() -> Optional[object]:
    """Return the native module, building it on first call; None if
    unavailable."""
    global _module, _tried
    if _module is not None or _tried:
        return _module
    with _lock:
        if _module is not None or _tried:
            return _module
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            spec = importlib.util.spec_from_file_location("mauve_native", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
            _module = mod
        except ImportError:
            _module = None
    return _module
