"""The port's CUDA kernels and its GPU main path, against the plain-torch
versions (exact: DP scores are integer-valued f32, ops and XMFA are bytes;
decision bytes are compared on each problem's live rectangle,
dp.live_cell_mask, the only bytes the forward kernels write).

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a machine with only
torch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.ops import _build, dp, gotoh_cuda
from mauvealigner_tpu_torch.utils import simulate

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from gotoh_replay import random_batch, random_profile_batch  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

GO, GE = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND


@pytest.fixture
def rng():
    return np.random.default_rng(37)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _batch(rng, B, side, dev, side_b=None):
    side_b = side if side_b is None else side_b
    la = rng.integers(1, side + 1, size=B).astype(np.int32)
    lb = rng.integers(1, side_b + 1, size=B).astype(np.int32)
    la[:4], lb[:4] = (1, 0, min(5, side), side), (1, min(7, side_b), 0, side_b)
    ca = np.full((B, side), 255, np.uint8)
    cb = np.full((B, side_b), 255, np.uint8)
    for k in range(B):
        a = rng.integers(0, 4, size=la[k])
        b = np.resize(a, lb[k]) if (k % 2 and la[k]) else rng.integers(0, 4, size=lb[k])
        ca[k, : la[k]] = a
        cb[k, : lb[k]] = np.where(rng.random(lb[k]) < 0.2, rng.integers(0, 5, size=lb[k]), b)
    return [torch.from_numpy(x).to(dev) for x in (ca, cb, la, lb)]


@pytest.mark.parametrize("side", [16, 64, 256, 1024])
def test_kernels_match_plain(rng, cuda_device, side):
    ca, cb, la, lb = _batch(rng, 12, side, cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    before = dict(gotoh_cuda.LAUNCHES)
    s_k, d_k = gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, GO, GE)
    s_p, d_p = dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, GO, GE)
    o_k, c_k = gotoh_cuda.gotoh_traceback(d_p, la, lb)
    o_p, c_p = dp.gotoh_traceback_ref(d_p, la, lb)
    torch.cuda.synchronize()
    live = dp.live_cell_mask(la, lb, side, side)
    assert torch.equal(s_k, s_p) and torch.equal(d_k[live], d_p[live])
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)
    assert gotoh_cuda.LAUNCHES["gotoh_forward_codes"] == before["gotoh_forward_codes"] + 1
    assert gotoh_cuda.LAUNCHES["gotoh_traceback"] == before["gotoh_traceback"] + 1


def _large_side_batch(rng, kind, side, dev):
    """B = 2 at one bucket side above shared memory: one problem with both
    lengths above the old limit (8192 codes, 4096 profiles), one with the
    A side long and the B side short."""
    lens = (np.array([side - 3, side // 2 + 7], np.int32),
            np.array([side - 11, 900], np.int32))
    if kind == "codes":
        arrs = random_batch(rng, 2, side, lens)
        return [torch.from_numpy(x).to(dev) for x in arrs]
    pa, pb, la, lb = random_profile_batch(rng, 2, side, lens)
    return [torch.from_numpy(pa).to(dev).to(torch.float32),
            torch.from_numpy(pb).to(dev).to(torch.float32),
            torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev)]


def _forward(kind, x, sub, normalize=False):
    if kind == "codes":
        return gotoh_cuda.gotoh_forward_codes(*x, sub, GO, GE)
    return gotoh_cuda.gotoh_forward_profiles(*x, sub, GO, GE, normalize)


def _plain_forward(kind, x, sub, normalize=False):
    if kind == "codes":
        return dp.gotoh_forward_codes_ref(*x, sub, GO, GE)
    return dp.gotoh_forward_profiles_ref(*x, sub, GO, GE, normalize)


@pytest.mark.parametrize("kind,side", [("codes", 16384), ("profiles", 8192)])
def test_kernel_runs_sides_past_shared_memory(rng, cuda_device, kind, side):
    """Sides whose row buffers and staged B side exceed a block's shared
    memory run through the device slab: scores exact, live decision bytes
    identical, and the traceback's ops and counts equal the plain
    version's, one launch of each counted."""
    x = _large_side_batch(rng, kind, side, cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    assert _build.library().gotoh_forward_scratch_bytes(
        2, side, int(kind == "profiles"), 0) > 0
    before = dict(gotoh_cuda.LAUNCHES)
    s_k, d_k = _forward(kind, x, sub)
    o_k, c_k = gotoh_cuda.gotoh_traceback(d_k, x[2], x[3])
    s_p, d_p = _plain_forward(kind, x, sub)
    o_p, c_p = dp.gotoh_traceback_ref(d_p, x[2], x[3])
    torch.cuda.synchronize()
    live = dp.live_cell_mask(x[2], x[3], side, side)
    assert torch.equal(s_k, s_p) and torch.equal(d_k[live], d_p[live])
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)
    key = f"gotoh_forward_{kind}"
    assert gotoh_cuda.LAUNCHES[key] == before[key] + 1
    assert gotoh_cuda.LAUNCHES["gotoh_traceback"] == before["gotoh_traceback"] + 1


@pytest.mark.parametrize("kind", ["codes", "profiles"])
@pytest.mark.parametrize("side", [64, 512])
def test_device_slab_at_small_sides(rng, cuda_device, kind, side):
    """A launcher shared-memory limit below one problem's buffer sends
    small sides through the device slab too: the same result."""
    import ctypes

    B, limit = 12, 1024
    x = _profiles(rng, B, side, cuda_device) if kind == "profiles" else _batch(
        rng, B, side, cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    lib = _build.library()
    go_ge, ge = dp.gap_scalars(GO, GE)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    p = _build.ptr
    nbytes = lib.gotoh_forward_scratch_bytes(B, side, int(kind == "profiles"), limit)
    assert nbytes > 0
    slab = torch.empty(nbytes, dtype=torch.uint8, device=cuda_device)
    scores = torch.empty(B, dtype=torch.float32, device=cuda_device)
    dec = torch.empty((B, 2 * side + 1, side + 1), dtype=torch.uint8, device=cuda_device)
    if kind == "codes":
        err = lib.gotoh_forward_codes_launch(
            *(p(t) for t in x), p(sub), go_ge, ge, B, side, side, 0, limit, p(slab),
            p(scores), p(dec), stream)
    else:
        err = lib.gotoh_forward_profiles_launch(
            *(p(t) for t in x), p(sub), go_ge, ge, B, side, side, 1, 0, limit, p(slab),
            p(scores), p(dec), stream)
    assert err == 0
    s_p, d_p = _plain_forward(kind, x, sub, True)
    torch.cuda.synchronize()
    live = dp.live_cell_mask(x[2], x[3], side, side)
    assert torch.equal(scores, s_p) and torch.equal(dec[live], d_p[live])


@pytest.mark.parametrize("warps", [1, 2, 3, 8, 16])
def test_every_block_shape_matches_plain(rng, cuda_device, warps):
    """Both forward kernels at one side with each number of warps per
    problem the launcher may pick (one warp walking its strips in turn, or
    a phased block), called through the library with the shape forced."""
    import ctypes

    from mauvealigner_tpu_torch.ops import _build

    side = 200
    ca, cb, la, lb = _batch(rng, 10, side, cuda_device)
    pa, pb, pla, plb = _profiles(rng, 10, side, cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    lib = _build.library()
    go_ge, ge = dp.gap_scalars(GO, GE)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    p = _build.ptr
    for kind in ("codes", "profiles"):
        scores = torch.empty(10, dtype=torch.float32, device=cuda_device)
        dec = torch.empty((10, 2 * side + 1, side + 1), dtype=torch.uint8, device=cuda_device)
        if kind == "codes":
            err = lib.gotoh_forward_codes_launch(
                p(ca), p(cb), p(la), p(lb), p(sub), go_ge, ge, 10, side, side, warps, 0, None,
                p(scores), p(dec), stream)
            s_p, d_p = dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, GO, GE)
            live = dp.live_cell_mask(la, lb, side, side)
        else:
            err = lib.gotoh_forward_profiles_launch(
                p(pa), p(pb), p(pla), p(plb), p(sub), go_ge, ge, 10, side, side, 1, warps, 0,
                None, p(scores), p(dec), stream)
            s_p, d_p = dp.gotoh_forward_profiles_ref(pa, pb, pla, plb, sub, GO, GE, True)
            live = dp.live_cell_mask(pla, plb, side, side)
        assert err == 0
        torch.cuda.synchronize()
        assert torch.equal(scores, s_p) and torch.equal(dec[live], d_p[live]), kind


def test_kernels_reject_positive_gap_scores(cuda_device):
    z = torch.zeros((1, 16), dtype=torch.uint8, device=cuda_device)
    n = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    with pytest.raises(ValueError, match="gap scores <= 0"):
        gotoh_cuda.gotoh_forward_codes(z, z, n, n, sub, 5.0, -1.0)
    zp = torch.zeros((1, 16, 5), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="gap scores <= 0"):
        gotoh_cuda.gotoh_forward_profiles(zp, zp, n, n, sub, -5.0, 1.0)


def test_aligner_gpu_matches_cpu(rng, cuda_device):
    """A pair with diverged stretches (recursion and real DP work) and an
    inversion: byte-identical XMFA from the GPU and CPU paths."""
    anc = simulate.random_genome(rng, 20000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    c = der.codes.copy()
    for a, b in ((2000, 2600), (5000, 5800), (12000, 12700)):
        hit = rng.random(b - a) < 0.45
        c[a:b][hit] = (c[a:b][hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    c[15000:17000] = (3 - c[15000:17000])[::-1]
    genomes = [anc, Genome(np.frombuffer(b"ACGTN", np.uint8)[c], name="der")]
    out = {}
    for dev in ("cpu", str(cuda_device)):
        gotoh_cuda.reset_launches()
        res = MauveAligner(AlignerOptions(seed_size=11, device=dev)).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[dev] = (buf.getvalue(), dict(gotoh_cuda.LAUNCHES))
    assert out["cpu"][0] == out[str(cuda_device)][0]
    assert set(out["cpu"][1].values()) == {0}
    gpu = out[str(cuda_device)][1]
    assert gpu["gotoh_forward_codes"] > 0 and gpu["gotoh_traceback"] > 0


def _profiles(rng, B, side, dev, side_b=None):
    """uint8 count profiles of 1-9 member rows, zero rows past each length,
    widened to f32 on the card."""
    ca, cb, la, lb = (x.cpu().numpy() for x in _batch(rng, B, side, "cpu", side_b))
    out = []
    for codes, lens in ((ca, la), (cb, lb)):
        prof = np.zeros((B, codes.shape[1], 5), np.uint8)
        for k in range(B):
            n = int(lens[k])
            for _ in range(int(rng.integers(1, 10))):
                c = codes[k, :n].astype(np.int64)
                hit = rng.random(n) < 0.1
                c[hit] = rng.integers(0, 6, size=int(hit.sum()))  # 5 = gap
                keep = c < 5
                np.add.at(prof[k], (np.arange(n)[keep], c[keep]), 1)
        out.append(torch.from_numpy(prof).to(dev).to(torch.float32))
    return out[0], out[1], torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("side", [16, 64, 256, 1024])
def test_profile_kernel_matches_plain(rng, cuda_device, side, normalize):
    pa, pb, la, lb = _profiles(rng, 12, side, cuda_device)
    sub = torch.from_numpy(dp.HOXD70.copy()).to(cuda_device)
    before = gotoh_cuda.LAUNCHES["gotoh_forward_profiles"]
    s_k, d_k = gotoh_cuda.gotoh_forward_profiles(pa, pb, la, lb, sub, GO, GE, normalize)
    s_p, d_p = dp.gotoh_forward_profiles_ref(pa, pb, la, lb, sub, GO, GE, normalize)
    torch.cuda.synchronize()
    live = dp.live_cell_mask(la, lb, side, side)
    assert torch.equal(s_k, s_p) and torch.equal(d_k[live], d_p[live])
    assert gotoh_cuda.LAUNCHES["gotoh_forward_profiles"] == before + 1


def test_progressive_gpu_matches_cpu(rng, cuda_device):
    """Three genomes through ProgressiveMauve (guide tree, hierarchical
    closure with count profiles, refinement, backbone): identical XMFA and
    backbone rows on the GPU and CPU paths, every kernel launched."""
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions

    anc = simulate.random_genome(rng, 6000)
    genomes = [anc] + [
        simulate.evolve(anc, rng, sub_rate=0.03, ins_rate=0.002, del_rate=0.002)[0]
        for _ in range(2)
    ]
    out = {}
    for dev in ("cpu", str(cuda_device)):
        gotoh_cuda.reset_launches()
        res = ProgressiveMauve(
            ProgressiveOptions(seed_weight=9, device=dev)
        ).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[dev] = (buf.getvalue(), res.backbone_rows, dict(gotoh_cuda.LAUNCHES))
    assert out["cpu"][0] == out[str(cuda_device)][0]
    assert np.array_equal(out["cpu"][1], out[str(cuda_device)][1])
    assert set(out["cpu"][2].values()) == {0}
    assert min(out[str(cuda_device)][2].values()) > 0


def test_pooled_ladder_gpu_launches_equal_serial(rng, cuda_device, monkeypatch):
    """The tree ladder on the card with its merges on a pool of 4 threads
    (MAUVE_TP_WORKERS=4): the serial run's XMFA and the same launch count
    per kernel (the pool's threads count under one lock)."""
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.utils import timing

    anc = simulate.random_genome(rng, 8000)
    genomes = [simulate.evolve(anc, rng, sub_rate=0.06, ins_rate=0.002, del_rate=0.002)[0]
               for _ in range(6)]
    out = {}
    for workers in ("1", "4"):
        monkeypatch.setenv("MAUVE_TP_WORKERS", workers)
        timing.GLOBAL.reset()
        gotoh_cuda.reset_launches()
        res = ProgressiveMauve(ProgressiveOptions(
            seed_weight=9, tree_progressive=True, use_sml_cache=False, device=str(cuda_device),
        )).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[workers] = (buf.getvalue(), dict(gotoh_cuda.LAUNCHES),
                        "tree_progressive/pool" in timing.GLOBAL.phases)
    assert out["4"][0] == out["1"][0]
    assert out["4"][1] == out["1"][1]
    assert out["4"][2] and not out["1"][2]
    assert out["4"][1]["gotoh_forward_codes"] > 0 and out["4"][1]["gotoh_traceback"] > 0


def test_progressive_mesh_gpu_matches_cpu(rng, cuda_device):
    """ProgressiveMauve (device search) under a mesh of three shards on the
    card: the CPU single-device XMFA and backbone rows, every kernel
    launched."""
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.parallel import Mesh

    anc = simulate.random_genome(rng, 6000)
    genomes = [anc] + [
        simulate.evolve(anc, rng, sub_rate=0.03, ins_rate=0.002, del_rate=0.002)[0]
        for _ in range(3)
    ]
    out = {}
    for dev, mesh in (("cpu", None), (str(cuda_device), Mesh((cuda_device,) * 3))):
        gotoh_cuda.reset_launches()
        res = ProgressiveMauve(ProgressiveOptions(
            seed_weight=9, use_sml_cache=False, device=dev, mesh=mesh)).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[dev] = (buf.getvalue(), res.backbone_rows, dict(gotoh_cuda.LAUNCHES))
    gpu = out[str(cuda_device)]
    assert out["cpu"][0] == gpu[0]
    assert np.array_equal(out["cpu"][1], gpu[1])
    assert min(gpu[2].values()) > 0


def test_mesh_across_cards_matches_cpu(rng, cuda_device):
    """One process, one shard per visible card (needs two cards or more):
    the sharded anchor search's all-to-all copies cross cards and every DP
    launch runs on its shard's card.  ProgressiveMauve equals the CPU
    single-device run, and every card allocated and launched."""
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two NVIDIA GPUs or more: one shard per card")
    anc = simulate.random_genome(rng, 8000)
    genomes = [anc] + [
        simulate.evolve(anc, rng, sub_rate=0.03, ins_rate=0.002, del_rate=0.002)[0]
        for _ in range(3)
    ]
    mesh = make_mesh(n, device="cuda")
    out = {}
    for dev, m in (("cpu", None), ("cuda", mesh)):
        for d in range(n):
            torch.cuda.reset_peak_memory_stats(d)
        gotoh_cuda.reset_launches()
        res = ProgressiveMauve(ProgressiveOptions(
            seed_weight=9, use_sml_cache=False, device=dev, mesh=m)).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[dev] = (buf.getvalue(), res.backbone_rows, dict(gotoh_cuda.LAUNCHES))
    assert out["cpu"][0] == out["cuda"][0]
    assert np.array_equal(out["cpu"][1], out["cuda"][1])
    assert min(out["cuda"][2].values()) > 0
    assert all(torch.cuda.max_memory_allocated(d) > 0 for d in range(n))


def test_repeatoire_gpu_matches_cpu(rng, cuda_device):
    """A few-kbp genome with a planted 5-copy family and an inverted copy
    through Repeatoire (sorted mer list, seed groups, extension waves through
    the closure, HMM gate): identical families and XMFA on the GPU and CPU
    paths, every kernel launched on the GPU."""
    from mauvealigner_tpu_torch.models.repeatoire import (
        Repeatoire, RepeatoireOptions, write_repeats_xmfa,
    )
    from mauvealigner_tpu_torch.genome.sequence import revcomp_ascii

    unit = simulate.random_genome(rng, 300).seq
    parts = [simulate.random_genome(rng, 500).seq]
    for i in range(5):
        copy = unit.copy()
        copy[rng.integers(0, 300, size=8)] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, size=8)]
        parts += [revcomp_ascii(copy) if i == 2 else copy, simulate.random_genome(rng, 500).seq]
    g = Genome(np.concatenate(parts), name="reps")
    out = {}
    for dev in ("cpu", str(cuda_device)):
        gotoh_cuda.reset_launches()
        fams = Repeatoire(RepeatoireOptions(z=9, device=dev)).find_repeats(g)
        buf = io.StringIO()
        write_repeats_xmfa(fams, g, buf)
        out[dev] = (buf.getvalue(), [f.score for f in fams], dict(gotoh_cuda.LAUNCHES))
    assert out["cpu"][0] == out[str(cuda_device)][0]
    assert out["cpu"][1] == out[str(cuda_device)][1]
    assert set(out["cpu"][2].values()) == {0}
    assert min(out[str(cuda_device)][2].values()) > 0


def test_wave_above_255_rows_gpu_matches_cpu(rng, cuda_device):
    """A 260-member extension job (repeatoire allows 500) through the
    balanced-plan closure: the last rounds merge f32 count profiles; the
    alignment on the GPU equals the CPU path's."""
    from mauvealigner_tpu_torch.models import closure

    unit = rng.integers(0, 4, size=40).astype(np.int8)
    regs = []
    for _ in range(260):
        r = unit[: rng.integers(20, 41)].copy()
        r[rng.integers(0, len(r), size=3)] = rng.integers(0, 4, size=3)
        regs.append(r)
    kw = dict(gap_open=-100.0, gap_extend=-20.0, max_len=4096)
    out = {}
    for dev in ("cpu", str(cuda_device)):
        gotoh_cuda.reset_launches()
        out[dev] = closure.hierarchical_align_region_groups(
            [regs], closure.balanced_plan(260), device=dev, **kw)[0]
    assert np.array_equal(out["cpu"], out[str(cuda_device)])
    assert gotoh_cuda.LAUNCHES["gotoh_forward_profiles"] > 0


POISON = 0xEE


def _poisoned_decisions(rng, kind, B, M, N, dev):
    """Decisions of one forward kernel with every byte outside the live
    rectangles set to POISON; returns (dec, lens_a, lens_b)."""
    sub = torch.from_numpy(dp.HOXD70.copy()).to(dev)
    if kind == "codes":
        x = _batch(rng, B, M, dev, N)
        _, dec = gotoh_cuda.gotoh_forward_codes(*x, sub, GO, GE)
    else:
        x = _profiles(rng, B, M, dev, N)
        _, dec = gotoh_cuda.gotoh_forward_profiles(*x, sub, GO, GE, True)
    dec[~dp.live_cell_mask(x[2], x[3], M, N)] = POISON
    return dec, x[2], x[3]


@pytest.mark.parametrize("side", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_traceback_on_poisoned_decisions(rng, cuda_device, side):
    """The traceback kernel on both forward kernels' decisions, dead bytes
    poisoned, square and non-square: ops and counts equal the plain
    version's, one launch counted each."""
    B = 48 if side <= 512 else (12 if side <= 1024 else 4)
    for M, N in ((side, side), (side, side // 2 + 3), (side // 4 + 1, side)):
        for kind in ("codes", "profiles"):
            dec, la, lb = _poisoned_decisions(rng, kind, B, M, N, cuda_device)
            before = gotoh_cuda.LAUNCHES["gotoh_traceback"]
            o_k, c_k = gotoh_cuda.gotoh_traceback(dec, la, lb)
            o_p, c_p = dp.gotoh_traceback_ref(dec, la, lb)
            torch.cuda.synchronize()
            assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p), (kind, M, N)
            assert gotoh_cuda.LAUNCHES["gotoh_traceback"] == before + 1


@pytest.mark.parametrize("per_block", range(8))
def test_traceback_every_block_shape(rng, cuda_device, per_block):
    """Each number of problems a block (0: the launcher's default) through
    the library, with B not a multiple of it."""
    import ctypes

    from mauvealigner_tpu_torch.ops import _build

    M, N, B = 300, 170, 23
    dec, la, lb = _poisoned_decisions(rng, "codes", B, M, N, cuda_device)
    ops = torch.empty((B, M + N), dtype=torch.uint8, device=cuda_device)
    counts = torch.empty(B, dtype=torch.int32, device=cuda_device)
    p = _build.ptr
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    err = _build.library().gotoh_traceback_launch(
        p(dec), p(la), p(lb), B, M, N, per_block, p(ops), p(counts), stream)
    assert err == 0
    o_p, c_p = dp.gotoh_traceback_ref(dec, la, lb)
    torch.cuda.synchronize()
    assert torch.equal(ops, o_p) and torch.equal(counts, c_p)


@pytest.mark.parametrize("M,N", [(40, 25), (700, 300)])
def test_traceback_on_random_bytes(rng, cuda_device, M, N):
    """Wholly random decision bytes: walks pass the origin and read
    clamped indices at both ends of each slab until L = M+N steps."""
    B = 40
    dec = torch.from_numpy(rng.integers(0, 256, size=(B, M + N + 1, M + 1), dtype=np.uint8))
    la = torch.from_numpy(rng.integers(0, M + 1, size=B).astype(np.int32))
    lb = torch.from_numpy(rng.integers(0, N + 1, size=B).astype(np.int32))
    la[0], lb[0] = M, N
    o_p, c_p = dp.gotoh_traceback_ref(dec, la, lb)
    o_k, c_k = gotoh_cuda.gotoh_traceback(*(t.to(cuda_device) for t in (dec, la, lb)))
    torch.cuda.synchronize()
    assert torch.equal(o_k.cpu(), o_p) and torch.equal(c_k.cpu(), c_p)


@pytest.mark.parametrize("tool", ["sortContigs", "uniqueMerCount"])
def test_device_subcommands_gpu_match_cpu(rng, cuda_device, tool, tmp_path):
    """sortContigs (MauveAligner's anchor search on the card) and
    uniqueMerCount (the K1 sort on the card) through the port's command
    line: the same standard output and output file on cuda as on cpu."""
    import contextlib

    from mauvealigner_tpu_torch.genome import write_fasta
    from mauvealigner_tpu_torch.tools.cli import main as cli

    ref, drafts = simulate.draft_genomes(12_000, 2, 4)
    write_fasta(ref, str(tmp_path / "ref.fa"))
    write_fasta(drafts[0], str(tmp_path / "draft.fa"))
    out = {}
    for dev in ("cpu", str(cuda_device)):
        argv = {"sortContigs": ["ref.fa", "draft.fa", f"--output={dev}.fa", "--seed-size=11"],
                "uniqueMerCount": ["draft.fa", "--seed-weight=11"]}[tool]
        buf = io.StringIO()
        with contextlib.chdir(tmp_path), contextlib.redirect_stdout(buf):
            assert cli([tool, *argv, f"--device={dev}"]) == 0
        written = (tmp_path / f"{dev}.fa").read_bytes() if tool == "sortContigs" else b""
        out[dev] = (buf.getvalue(), written)
    assert out["cpu"] == out[str(cuda_device)] and out["cpu"][0].strip()


def test_draft_workflow_gpu_matches_cpu(cuda_device):
    """A 12 kbp reference and two 4-contig drafts through the draft
    workflow (anchor search, sortContigs, ProgressiveMauve): the same
    placement logs and XMFA on the GPU and CPU paths, every kernel
    launched on the GPU."""
    from mauvealigner_tpu_torch.models import aligner
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu_torch.tools import manipulate
    from mauvealigner_tpu_torch.utils import digest

    ref, drafts = simulate.draft_genomes(12_000, 3, 4)
    out = {}
    for dev in ("cpu", str(cuda_device)):
        gotoh_cuda.reset_launches()
        reordered, logs = digest.sort_drafts(ref, drafts, aligner, manipulate,
                                             seed_size=11, device=dev)
        res = ProgressiveMauve(ProgressiveOptions(seed_weight=11, use_sml_cache=False,
                                                  device=dev)).align([ref] + reordered)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        out[dev] = (logs, buf.getvalue(), dict(gotoh_cuda.LAUNCHES))
    assert out["cpu"][:2] == out[str(cuda_device)][:2]
    assert min(out[str(cuda_device)][2].values()) > 0
