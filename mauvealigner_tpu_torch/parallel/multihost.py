"""Multi-process execution over torch.distributed.

Port of mauvealigner_tpu/parallel/multihost.py (reference analog: the
MPI-distributed mpiMauveAligner whose sources are absent from the
snapshot, projects/mpiMauveAligner.vcproj:118-122, and the file-based
offset-partitioned match logs, src/mauveAligner.cpp:533-589).  The same
sharded programs run over a mesh whose shards are the ranks of a process
group: each rank holds one shard on its own device, and the collectives
are torch.distributed calls (NCCL on CUDA, gloo on the CPU).

Usage (per process):
    init_multihost("tcp://host:port", num_processes, process_id, device)
    mesh = global_mesh(device)
    ml = find_multi_mums_sharded(genomes, smls_dev, mesh, ...)  # unchanged

Genomes are replicated per process; each rank keeps its own row block of
the entry arrays (scatter_global) and the compact candidate tables gather
back to every rank (fetch_replicated), so all ranks hold the same
MatchList.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from mauvealigner_tpu_torch.parallel.sharded import Mesh


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: its own card (by rank, modulo the visible count)
    on CUDA, the CPU otherwise."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return torch.device("cpu")


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device="cuda", force: bool = False) -> None:
    """Join the process group: NCCL when `device` is CUDA (this rank's card
    made current), gloo on the CPU, initialized from `coordinator` ("host:port"
    or "tcp://host:port" of rank 0).  Idempotent per process, and a no-op at
    one process unless `force` (a world-size-1 group, which runs the
    collective path on one card)."""
    if dist.is_initialized() or (num_processes <= 1 and not force):
        return
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = _rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=url, world_size=num_processes, rank=process_id,
    )


def global_mesh(device="cuda") -> Mesh:
    """One shard per rank of the default process group, each on its rank's
    device; a one-process mesh on `device` when no group is initialized."""
    if not dist.is_initialized():
        return Mesh((_rank_device(device, 0),))
    n = dist.get_world_size()
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(tuple(_rank_device(kind, r) for r in range(n)), group=dist.group.WORLD)


def scatter_global(x, mesh: Mesh) -> Dict[int, torch.Tensor]:
    """A tensor (or numpy array) replicated on every process -> this
    process's row blocks of it, one per local shard: shard d gets rows
    [d*per, (d+1)*per) on devices[d] (the row count must divide by the mesh
    size).  With one process that is every shard's block."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    n = int(x.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} shards")
    per = n // mesh.size
    return {d: x[d * per : (d + 1) * per].to(mesh.devices[d]) for d in mesh.local_shards()}


def fetch_replicated(local: Dict[int, torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Every shard's tensor (equal shapes) stacked in shard order, on the
    host of every process (an all_gather under a group)."""
    parts = mesh.gather({d: t.cpu().numpy() for d, t in local.items()})
    return np.stack([parts[d] for d in range(mesh.size)])
