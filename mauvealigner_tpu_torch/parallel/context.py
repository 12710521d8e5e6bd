"""Active-mesh context: opt whole pipelines into mesh execution.

Port of mauvealigner_tpu/parallel/context.py.  A model enters
`use_mesh(mesh)` once, and every batched kernel underneath (K3 Gotoh
closure, K4 HMM decode) consults `active_mesh()` and splits its batch over
the mesh's shards.  Per-element kernels split losslessly, so mesh output is
bit-identical to single-device output.

Thread-local so concurrent node merges can run under different meshes, or
none, without interference; worker pools must propagate the mesh
explicitly (capture `active_mesh()` at submit time, re-enter `use_mesh` in
the worker).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

_state = threading.local()


def active_mesh() -> Optional[object]:
    """The mesh batched kernels should shard over, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[object]):
    """Make `mesh` the ambient mesh for this thread.  None is a no-op (the
    enclosing mesh, if any, stays active, so an un-meshed inner aligner
    inside a meshed pipeline still shards its kernels)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh if mesh is not None else prev
    try:
        yield
    finally:
        _state.mesh = prev


def _to_host(out):
    """A kernel's output (a tensor or a tuple of tensors) as numpy."""
    if isinstance(out, tuple):
        return tuple(t.cpu().numpy() for t in out)
    return out.cpu().numpy()


def _concat(parts):
    """Concatenate per-shard host outputs along the batch axis, in shard
    order."""
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p) for p in zip(*parts))
    return np.concatenate(parts)


def _on_shard(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def shard_batched_call_async(kernel, batch_arrays, replicated_args=(), mesh=None,
                             device="cuda"):
    """Dispatch `kernel(*batch_arrays, *replicated_args, device=dev)` under
    the active mesh: the batch axis (axis 0 of every batch array) is split
    over the mesh's shards with torch.tensor_split's sizes, and the kernel
    runs once per non-empty shard with that shard's rows and its device;
    without a mesh the kernel runs once on `device`.  Tensor arguments move
    to the kernel's device, numpy arguments pass as they are (the kernel
    ships them).  The kernel returns a tensor or a tuple of tensors with the
    batch on axis 0.  Returns a zero-arg `fetch()` closure that downloads
    the shards' outputs and concatenates them in shard order: numpy, [B, ...]
    (a tuple of them for a tuple output).

    Launches are asynchronous on a CUDA device; fetch() blocks, so callers
    with many bucket launches dispatch them all first and fetch afterwards.
    Splitting instead of padding keeps zero-length problems away from the
    kernels, and a shard left without rows launches nothing.  Under a
    multi-process mesh each rank runs its own shard and fetch() gathers
    every rank's rows (all ranks must fetch in the same order).

    The kernel must be per-batch-element independent; then the result is
    bit-identical to the direct call."""
    if mesh is None:
        mesh = active_mesh()
    B = int(batch_arrays[0].shape[0])
    if mesh is None:
        out = kernel(*[_on_shard(a, device) for a in (*batch_arrays, *replicated_args)],
                     device=device)
        return lambda: _to_host(out)
    local = mesh.local_shards()
    if B == 0:
        dev = mesh.devices[local[0]]
        out = kernel(*[_on_shard(a, dev) for a in (*batch_arrays, *replicated_args)],
                     device=dev)
        return lambda: _to_host(out)
    # torch.tensor_split's sizes: the first B % D shards take one row more
    D = mesh.size
    bounds = [d * (B // D) + min(d, B % D) for d in range(D + 1)]
    outs = {}
    for d in local:
        lo, hi = bounds[d], bounds[d + 1]
        if lo == hi:
            continue
        dev = mesh.devices[d]
        outs[d] = kernel(
            *[_on_shard(a[lo:hi], dev) for a in batch_arrays],
            *[_on_shard(r, dev) for r in replicated_args],
            device=dev,
        )

    def fetch():
        parts = mesh.gather({d: _to_host(o) for d, o in outs.items()})
        return _concat([parts[d] for d in sorted(parts)])

    return fetch


def shard_batched_call(kernel, batch_arrays, replicated_args=(), mesh=None, device="cuda"):
    """Blocking shard_batched_call_async: returns the host numpy output."""
    return shard_batched_call_async(kernel, batch_arrays, replicated_args, mesh, device)()
