"""Multi-process execution of the port's sharded programs: OS processes,
one shard each, joined by torch.distributed (parallel/multihost.py), on
the 4 kbp pair of tests/test_multihost.py.  Each rank runs the two-phase
all-to-all anchor search, the pair-sharded draft search and a batch split
over the ranks; every rank must hold the single-device results.  Two
processes over gloo on the CPU here; on a machine with several NVIDIA
GPUs one process per card over NCCL (marker gpu, skipped otherwise):

    python -m pytest --noconftest tests/test_torch_multihost.py -m gpu

Run as a script, this file is one rank:
    python tests/test_torch_multihost.py RANK WORLD PORT OUT_PREFIX DEVICE
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def _inputs():
    """The genomes of tests/multihost_worker.py (seed 37), and three drafts
    of the first for the pair search."""
    from mauvealigner_tpu_torch.utils import simulate

    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 4000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    drafts = [simulate.evolve(anc, rng, sub_rate=0.03)[0] for _ in range(3)]
    return [anc, der], drafts


def _rows(ml):
    return np.concatenate([ml.starts, ml.lengths[:, None]], axis=1)


def _run(mesh, device="cpu"):
    """(N-way matches, per-draft pair matches, a split batch's output) over
    `mesh` (this rank's lists built on `device`); mesh None = single device
    on the CPU."""
    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.ops import matchops
    from mauvealigner_tpu_torch.parallel import context, sharded
    from mauvealigner_tpu_torch.seeds import get_seed

    genomes, drafts = _inputs()
    seed = get_seed(9, 0)
    smls = [build_mer_list_device(g, seed, device) for g in genomes]
    x = torch.arange(35, dtype=torch.float64).reshape(7, 5)
    if mesh is None:
        ml = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
        pairs = [
            matchops.find_multi_mums_device(
                [genomes[0], d], [smls[0], build_mer_list_device(d, seed, "cpu")],
                seed_length=seed.length,
            )
            for d in drafts
        ]
    else:
        ml = sharded.find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
        pairs = sharded.find_pair_mums_sharded(genomes[0], drafts, seed, mesh)
    batch = context.shard_batched_call(lambda a, device: a * a + 1, [x], mesh=mesh, device=device)
    return ml, pairs, batch


def _worker(rank: int, world: int, port: int, out_prefix: str, device: str) -> None:
    import torch.distributed as dist

    from mauvealigner_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.init_multihost(f"localhost:{port}", world, rank, device=device)
    try:
        mesh = multihost.global_mesh(device)
        assert mesh.size == world and mesh.local_shards() == [rank]
        ml, pairs, batch = _run(mesh, mesh.devices[rank])
        np.savez(f"{out_prefix}{rank}.npz", nway=_rows(ml), batch=batch,
                 **{f"pair{i}": _rows(p) for i, p in enumerate(pairs)})
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: {len(ml)} matches", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks_match_single_device(tmp_path, world: int, device: str) -> None:
    """`world` worker processes over `device`'s backend; every rank's
    results equal the single-device search's."""
    torch.set_num_threads(1)
    port = _free_port()
    prefix = str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    if device == "cuda":
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on loopback
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), prefix,
             device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ml, pairs, batch = _run(None)
    for r in range(world):
        got = np.load(f"{prefix}{r}.npz")
        # the sharded search sorts its rows canonically
        assert np.array_equal(got["nway"], np.unique(_rows(ml), axis=0))
        for i, p in enumerate(pairs):
            assert np.array_equal(got[f"pair{i}"], _rows(p))
        assert np.array_equal(got["batch"], batch)
    assert len(ml) > 0 and all(len(p) > 0 for p in pairs)


def test_two_process_sharded_search_matches_single_device(tmp_path):
    _ranks_match_single_device(tmp_path, 2, "cpu")


@pytest.mark.gpu
def test_nccl_ranks_across_cards_match_single_device(tmp_path):
    """One rank per visible card over NCCL (needs two cards or more)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two NVIDIA GPUs or more: one NCCL rank per card")
    _ranks_match_single_device(tmp_path, n, "cuda")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
