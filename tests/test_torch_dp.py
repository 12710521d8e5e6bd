"""K3 parity: the port's plain-torch Gotoh forward pass and traceback equal
the JAX package's scan and Pallas (interpret mode) paths, and the closure
drivers give the same alignments.  Tolerance is exact: with HOXD70 and
integer gap scores every DP value is an integer-valued f32.  The CUDA
kernels are held against the plain versions in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.models import closure as jax_closure
from mauvealigner_tpu.ops import dp as jax_dp
from mauvealigner_tpu.ops.dp_pallas import gotoh_forward_pallas
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.ops import dp, gotoh_cuda

torch.set_num_threads(1)

GO, GE = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND


def _batch(rng, B, M, N, edges=True):
    """Random code pairs (with a few N codes) padded with 255, lengths up to
    the sides; the first rows are edge cases when `edges`."""
    la = rng.integers(1, M + 1, size=B).astype(np.int32)
    lb = rng.integers(1, N + 1, size=B).astype(np.int32)
    if edges:
        for k, (x, y) in enumerate([(1, 1), (0, 3), (4, 0), (M, N)][: B // 2]):
            la[k], lb[k] = x, y
    ca = np.full((B, M), 255, np.uint8)
    cb = np.full((B, N), 255, np.uint8)
    for k in range(B):
        a = rng.integers(0, 4, size=la[k])
        b = np.resize(a, lb[k]) if (k % 2 and la[k]) else rng.integers(0, 4, size=lb[k])
        b = np.where(rng.random(lb[k]) < 0.2, rng.integers(0, 5, size=lb[k]), b)
        ca[k, : la[k]] = a
        cb[k, : lb[k]] = b
    return ca, cb, la, lb


def _one_hot(codes, lens, side):
    return np.stack([jax_dp.one_hot_profile(c[:n], side) for c, n in zip(codes, lens)])


def _plain(ca, cb, la, lb):
    t = [torch.from_numpy(x) for x in (ca, cb, la, lb)]
    scores, dec = dp.gotoh_forward_codes_ref(*t, torch.from_numpy(dp.HOXD70.copy()), GO, GE)
    ops, counts = dp.gotoh_traceback_ref(dec, t[2], t[3])
    return scores.numpy(), dec, ops.numpy(), counts.numpy()


@pytest.mark.parametrize("M,N", [(16, 16), (48, 48), (40, 24)])
def test_plain_matches_jax_scan(rng, M, N):
    ca, cb, la, lb = _batch(rng, 8, M, N)
    s_ref, dec_ref = jax_dp.gotoh_forward_scored(
        jnp.asarray(_one_hot(ca, la, M)), jnp.asarray(_one_hot(cb, lb, N)),
        jnp.asarray(la), jnp.asarray(lb), jnp.asarray(jax_dp.HOXD70),
        jnp.float32(GO), jnp.float32(GE), M, N,
    )
    ops_ref, cnt_ref = jax_dp.gotoh_traceback(dec_ref, jnp.asarray(la), jnp.asarray(lb), M, N)
    scores, dec, ops, counts = _plain(ca, cb, la, lb)
    assert np.array_equal(np.asarray(s_ref), scores)
    assert np.array_equal(np.asarray(cnt_ref), counts)
    assert np.array_equal(np.asarray(ops_ref), ops)
    # the port's traceback reads the JAX decisions the same way
    ops2, cnt2 = dp.gotoh_traceback_ref(
        torch.from_numpy(np.array(dec_ref)), torch.from_numpy(la), torch.from_numpy(lb)
    )
    assert np.array_equal(np.asarray(ops_ref), ops2.numpy())
    assert np.array_equal(np.asarray(cnt_ref), cnt2.numpy())


@pytest.mark.parametrize("M", [16, 48])
def test_plain_matches_pallas_interpret(rng, M):
    ca, cb, la, lb = _batch(rng, 4, M, M)
    s_pal, dec_pal = gotoh_forward_pallas(
        jnp.asarray(_one_hot(ca, la, M)), jnp.asarray(_one_hot(cb, lb, M)),
        jnp.asarray(la), jnp.asarray(lb), jnp.asarray(jax_dp.HOXD70),
        jnp.float32(GO), jnp.float32(GE), M, M, interpret=True,
    )
    ops_pal, cnt_pal = jax_dp.gotoh_traceback(dec_pal, jnp.asarray(la), jnp.asarray(lb), M, M)
    scores, _, ops, counts = _plain(ca, cb, la, lb)
    assert np.array_equal(np.asarray(s_pal), scores)
    assert np.array_equal(np.asarray(cnt_pal), counts)
    assert np.array_equal(np.asarray(ops_pal), ops)


def _region_groups(rng):
    groups = [
        (np.zeros(0, np.int64), np.zeros(0, np.int64)),      # empty
        (rng.integers(0, 4, 12), np.zeros(0, np.int64)),     # one-sided
        (np.zeros(0, np.int64), rng.integers(0, 4, 9)),      # one-sided
        (rng.integers(0, 4, 70), rng.integers(0, 4, 20)),    # over the cap
    ]
    for n in (1, 5, 17, 33, 60):  # several buckets
        a = rng.integers(0, 5, n)
        b = np.concatenate([a[: n // 2], rng.integers(0, 4, 3), a[n // 2 :]])
        groups.append((a, b))
    return groups


def test_pairwise_align_region_groups_matches_jax(rng):
    groups = _region_groups(rng)
    ref = jax_closure._pairwise_align_region_groups(groups, jax_dp.HOXD70, GO, GE, 64)
    got = closure._pairwise_align_region_groups(groups, dp.HOXD70, GO, GE, 64, "cpu")
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert closure.align_region_groups(groups, max_len=64, device="cpu")[-1].shape == got[-1].shape


def test_align_region_groups_rejects_more_than_two_sequences(rng):
    """Groups of three sequences are no longer rejected: the star closure
    (code pairs, then count profiles) gives the JAX package's alignments."""
    groups = []
    for n in (1, 9, 30, 70):
        a = rng.integers(0, 5, n)
        groups.append([a, np.concatenate([a[: n // 2], rng.integers(0, 4, 2), a[n // 2 :]]),
                       rng.integers(0, 4, max(n - 3, 0))])
    groups.append([np.zeros(0, np.int64), rng.integers(0, 4, 5), rng.integers(0, 4, 6)])
    ref = jax_closure.align_region_groups(groups, max_len=64)
    got = closure.align_region_groups(groups, max_len=64, device="cpu")
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)


def test_align_sequence_pairs_matches_jax(rng):
    pairs = [(a, b) for a, b in _region_groups(rng) if len(a) <= 64]
    ref = jax_dp.align_sequence_pairs(pairs)
    got = dp.align_sequence_pairs(pairs, device="cpu")
    assert all(np.array_equal(r, g) for r, g in zip(ref, got))


def test_read_substitution_matrix_matches_jax(tmp_path):
    path = tmp_path / "m.txt"
    path.write_text("# test\n   A  C  G  T  N\nA 5 -4 -4 -4 -2\nC -4 5 -4 -4 -2\n"
                    "G -4 -4 5 -4 -2\nT -4 -4 -4 5 -2\nN -2 -2 -2 -2 -1\n")
    assert np.array_equal(jax_dp.read_substitution_matrix(str(path)),
                          dp.read_substitution_matrix(str(path)))


def test_cpu_tensors_take_the_plain_version(rng):
    ca, cb, la, lb = (torch.from_numpy(x) for x in _batch(rng, 4, 16, 16))
    sub = torch.from_numpy(dp.HOXD70.copy())
    before = dict(gotoh_cuda.LAUNCHES)
    s1, d1 = gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, GO, GE)
    s2, d2 = dp.gotoh_forward_codes_ref(ca, cb, la, lb, sub, GO, GE)
    o1, c1 = gotoh_cuda.gotoh_traceback(d1, la, lb)
    o2, c2 = dp.gotoh_traceback_ref(d2, la, lb)
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert torch.equal(o1, o2) and torch.equal(c1, c2)
    assert gotoh_cuda.LAUNCHES == before


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MauveAligner(AlignerOptions(device="cuda"))


def _live_inputs(rng, kind, B, side):
    """Code pairs or count profiles at one bucket side, with edge lengths
    0 and side among them; returns (forward inputs, la, lb)."""
    ca, cb, la, lb = _batch(rng, B, side, side)
    for k, (x, y) in enumerate([(0, 0), (0, side), (side, 0), (side, side), (1, side)]):
        la[k], lb[k] = x, y
    t = [torch.from_numpy(x) for x in (ca, cb, la, lb)]
    if kind == "codes":
        return t, la, lb
    pa = torch.from_numpy(_one_hot(ca, la, side) * rng.integers(1, 4, size=(B, side, 1)))
    pb = torch.from_numpy(_one_hot(cb, lb, side) * rng.integers(1, 4, size=(B, side, 1)))
    return [pa.float(), pb.float(), t[2], t[3]], la, lb


def _forward_ref(kind, args, go=GO, ge=GE):
    sub = torch.from_numpy(dp.HOXD70.copy())
    if kind == "codes":
        return dp.gotoh_forward_codes_ref(*args, sub, go, ge)
    return dp.gotoh_forward_profiles_ref(*args, sub, go, ge, True)


@pytest.mark.parametrize("kind", ["codes", "profiles"])
def test_live_cell_mask_holds_everything_the_traceback_reads(rng, kind):
    """The mask counts sum (la+1)(lb+1) cells, and random bytes outside it
    leave the traceback's ops and counts unchanged: the premise of kernels
    that write the live rectangle only."""
    side = 24
    args, la, lb = _live_inputs(rng, kind, 9, side)
    _, dec = _forward_ref(kind, args)
    mask = dp.live_cell_mask(args[2], args[3], side, side)
    assert mask.shape == dec.shape and mask.dtype == torch.bool
    assert int(mask.sum()) == int(((la.astype(np.int64) + 1) * (lb + 1)).sum())
    noisy = torch.from_numpy(rng.integers(0, 256, size=tuple(dec.shape), dtype=np.uint8))
    noisy[mask] = dec[mask]
    ops, counts = dp.gotoh_traceback_ref(dec, args[2], args[3])
    ops2, counts2 = dp.gotoh_traceback_ref(noisy, args[2], args[3])
    assert torch.equal(ops, ops2) and torch.equal(counts, counts2)


@pytest.mark.parametrize("go,ge", [(GO, GE), (-10.0, -1.0), (-0.3, -0.7), (0.0, 0.0), (-1000.0, -100.0)])
@pytest.mark.parametrize("kind", ["codes", "profiles"])
def test_edge_bytes_follow_the_sentinel_closed_form(rng, kind, go, ge):
    """Row 0 and column 0 of the live rectangle hold the bytes the CUDA
    kernels write from the NEG sentinels, as f32 rounds them: row 0 is an
    E run whose F-open bit is f32(NEG + go_ge) >= f32(NEG + ge), column 0
    an F run whose E-open bit is that same value."""
    side = 20
    args, la, lb = _live_inputs(rng, kind, 8, side)
    _, dec = _forward_ref(kind, args, go, ge)
    f32 = np.float32
    go_ge, gev = (f32(x) for x in dp.gap_scalars(go, ge))
    neg = f32(dp.NEG)
    edge_open = bool(f32(neg + go_ge) >= f32(neg + gev))
    for b in range(len(la)):
        assert int(dec[b, 0, 0]) == 0
        e = f32(0.0)  # H(0, j-1) = E(0, j-1) for j >= 2; H(0,0) = 0, E(0,0) = NEG
        for j in range(1, int(lb[b]) + 1):
            e_prev = neg if j == 1 else e
            e_open = bool(f32(e + go_ge) >= f32(e_prev + gev))
            e = max(f32(e + go_ge), f32(e_prev + gev))
            assert int(dec[b, j, 0]) == 2 | (e_open << 2) | (edge_open << 3), (b, j)
        f = f32(0.0)
        for i in range(1, int(la[b]) + 1):
            f_prev = neg if i == 1 else f
            f_open = bool(f32(f + go_ge) >= f32(f_prev + gev))
            f = max(f32(f + go_ge), f32(f_prev + gev))
            assert int(dec[b, i, i]) == 1 | (edge_open << 2) | (f_open << 3), (b, i)


def test_batch_calls_record_launch_shapes(rng):
    """align_*_batch_async append each forward call's shape and host
    lengths to gotoh_cuda.LAUNCH_SHAPES; reset_launches() clears it."""
    ca, cb, la, lb = _batch(rng, 5, 16, 16)
    gotoh_cuda.reset_launches()
    dp.align_code_pairs_batch(ca, cb, la, lb, device="cpu")
    pa, pb = _one_hot(ca, la, 16).astype(np.uint8), _one_hot(cb, lb, 16).astype(np.uint8)
    dp.align_profiles_batch(pa, pb, la, lb, normalize=True, device="cpu")
    got = gotoh_cuda.LAUNCH_SHAPES
    assert [(g["kernel"], g["M"], g["N"], g["B"], g["normalize"]) for g in got] == [
        ("gotoh_forward_codes", 16, 16, 5, False), ("gotoh_forward_profiles", 16, 16, 5, True)]
    for g in got:
        assert np.array_equal(g["lens_a"], la) and np.array_equal(g["lens_b"], lb)
    assert set(gotoh_cuda.LAUNCHES.values()) == {0}
    gotoh_cuda.reset_launches()
    assert gotoh_cuda.LAUNCH_SHAPES == []
