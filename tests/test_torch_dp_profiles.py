"""K3 parity, profile input: the port's plain-torch Gotoh forward pass over
count profiles (and the traceback of its decisions) against the JAX
package's f32 scan path gotoh_forward_scored, and against the Pallas kernel
in interpret mode on one-hot profiles.

Tolerances: on uint8 count profiles with the integer HOXD70 every product
and partial sum is an integer below 2^24, so scores and op strings are
exact.  With normalize=True the JAX score comes from XLA's einsum order and
the port's from a fixed per-cell order: scores agree to 1e-5 relative and
the op strings are equal on these seeds (ROADMAP Queue C records the bound).
The CUDA kernel is held against the plain version in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.models import closure as jax_closure
from mauvealigner_tpu.ops import dp as jax_dp
from mauvealigner_tpu.ops.dp_pallas import gotoh_forward_pallas
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.ops import dp, gotoh_cuda

torch.set_num_threads(1)

GO, GE = dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND
NORMALIZE_RTOL = 1e-5


def _profiles(rng, B, M, N, max_rows=9):
    """uint8 count profiles of 1..max_rows member rows (5% gap cells, a few
    N), zero rows past each length; odd problems pair related sides; the
    first rows are edge cases (1 x 1, empty sides, full side)."""
    la = rng.integers(1, M + 1, size=B).astype(np.int32)
    lb = rng.integers(1, N + 1, size=B).astype(np.int32)
    for k, (x, y) in enumerate([(1, 1), (0, 3), (4, 0), (M, N)][: B // 2]):
        la[k], lb[k] = x, y
    pa = np.zeros((B, M, 5), np.uint8)
    pb = np.zeros((B, N, 5), np.uint8)
    for k in range(B):
        a = rng.integers(0, 4, size=la[k])
        b = np.resize(a, lb[k]) if (k % 2 and la[k]) else rng.integers(0, 4, size=lb[k])
        for prof, base in ((pa[k], a), (pb[k], b)):
            for _ in range(int(rng.integers(1, max_rows + 1))):
                c = base.astype(np.int64)
                hit = rng.random(len(c)) < 0.15
                c[hit] = rng.integers(0, 6, size=int(hit.sum()))  # 5 = gap
                keep = c < 5
                np.add.at(prof, (np.arange(len(c))[keep], c[keep]), 1)
    return pa, pb, la, lb


def _jax(pa, pb, la, lb, normalize):
    M, N = pa.shape[1], pb.shape[1]
    s, dec = jax_dp.gotoh_forward_scored(
        jnp.asarray(pa, jnp.float32), jnp.asarray(pb, jnp.float32),
        jnp.asarray(la), jnp.asarray(lb), jnp.asarray(jax_dp.HOXD70),
        jnp.float32(GO), jnp.float32(GE), M, N, normalize=normalize,
    )
    ops, cnt = jax_dp.gotoh_traceback(dec, jnp.asarray(la), jnp.asarray(lb), M, N)
    return np.asarray(s), np.asarray(ops), np.asarray(cnt)


def _port(pa, pb, la, lb, normalize):
    t = [torch.from_numpy(x) for x in (pa, pb, la, lb)]
    s, dec = dp.gotoh_forward_profiles_ref(
        t[0].float(), t[1].float(), t[2], t[3],
        torch.from_numpy(dp.HOXD70.copy()), GO, GE, normalize,
    )
    ops, cnt = dp.gotoh_traceback_ref(dec, t[2], t[3])
    return s.numpy(), ops.numpy(), cnt.numpy()


@pytest.mark.parametrize("M,N", [(16, 16), (48, 48), (40, 24)])
def test_count_profiles_match_jax_scan_exactly(rng, M, N):
    pa, pb, la, lb = _profiles(rng, 8, M, N)
    s_ref, ops_ref, cnt_ref = _jax(pa, pb, la, lb, False)
    s, ops, cnt = _port(pa, pb, la, lb, False)
    assert np.array_equal(s_ref, s)
    assert np.array_equal(cnt_ref, cnt) and np.array_equal(ops_ref, ops)


@pytest.mark.parametrize("M,N", [(16, 16), (48, 48), (40, 24)])
def test_normalized_profiles_match_jax_scan(rng, M, N):
    pa, pb, la, lb = _profiles(rng, 8, M, N)
    s_ref, ops_ref, cnt_ref = _jax(pa, pb, la, lb, True)
    s, ops, cnt = _port(pa, pb, la, lb, True)
    np.testing.assert_allclose(s, s_ref, rtol=NORMALIZE_RTOL, atol=0)
    assert np.array_equal(cnt_ref, cnt) and np.array_equal(ops_ref, ops)


@pytest.mark.parametrize("M", [16, 32])
def test_one_hot_profiles_match_pallas_interpret(rng, M):
    pa, pb, la, lb = _profiles(rng, 4, M, M, max_rows=1)
    pa, pb = (np.minimum(p, 1).astype(np.float32) for p in (pa, pb))  # one-hot or zero
    s_pal, dec_pal = gotoh_forward_pallas(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(jax_dp.HOXD70), jnp.float32(GO), jnp.float32(GE), M, M, interpret=True,
    )
    ops_pal, cnt_pal = jax_dp.gotoh_traceback(dec_pal, jnp.asarray(la), jnp.asarray(lb), M, M)
    s, ops, cnt = _port(pa, pb, la, lb, False)
    assert np.array_equal(np.asarray(s_pal), s)
    assert np.array_equal(np.asarray(cnt_pal), cnt)
    assert np.array_equal(np.asarray(ops_pal), ops)


def test_one_hot_profiles_equal_code_pairs(rng):
    """Both input modes share one recurrence: one-hot profiles give the
    code-pair path's decision bytes, every cell included."""
    pa, pb, la, lb = _profiles(rng, 6, 24, 24, max_rows=1)
    ca = np.where(pa.any(axis=2), pa.argmax(axis=2), 255).astype(np.uint8)
    cb = np.where(pb.any(axis=2), pb.argmax(axis=2), 255).astype(np.uint8)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    sub = t(dp.HOXD70.copy())
    s1, d1 = dp.gotoh_forward_codes_ref(t(ca), t(cb), t(la), t(lb), sub, GO, GE)
    s2, d2 = dp.gotoh_forward_profiles_ref(
        t(np.minimum(pa, 1)).float(), t(np.minimum(pb, 1)).float(), t(la), t(lb), sub, GO, GE
    )
    assert torch.equal(s1, s2) and torch.equal(d1, d2)


@pytest.mark.parametrize("normalize", [False, True])
def test_align_profiles_batch_matches_jax(rng, normalize):
    pa, pb, la, lb = _profiles(rng, 6, 32, 32)
    ops_ref, s_ref = jax_dp.align_profiles_batch(pa, pb, la, lb, normalize=normalize)
    ops, s = dp.align_profiles_batch(pa, pb, la, lb, normalize=normalize, device="cpu")
    assert all(np.array_equal(r, g) for r, g in zip(ops_ref, ops))
    np.testing.assert_allclose(s, s_ref, rtol=NORMALIZE_RTOL if normalize else 0, atol=0)


def test_batched_profile_pair_align_matches_jax(rng):
    """Column-code matrices of several member rows, bucketed by side, through
    the K3 batcher's profile entry point (the hierarchical merge's
    multi-row sides) against the JAX closure's profile batching."""
    ccs = []
    for n in (3, 17, 40, 90, 150):
        base = rng.integers(0, 4, n)
        for rows in (2, 3):
            cc = np.repeat(base[None, :], rows, axis=0).astype(np.int8)
            hit = rng.random(cc.shape) < 0.2
            cc[hit] = rng.integers(0, 6, size=int(hit.sum()))
            ccs.append(cc)
    profs = closure._profiles_of_many(ccs)
    ref_profs = jax_closure._profiles_of_many(ccs)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(profs, ref_profs))
    pairs = [(profs[i], ccs[i].shape[1], profs[i + 1], ccs[i + 1].shape[1])
             for i in range(0, len(ccs), 2)]
    ref = jax_closure._batched_profile_pair_align(pairs, jax_dp.HOXD70, GO, GE)
    got = dp.align_profile_pairs([(pa, pb) for pa, _, pb, _ in pairs], dp.HOXD70, GO, GE,
                                 device="cpu")
    assert len(ref) == len(got) and all(np.array_equal(r, g) for r, g in zip(ref, got))


def test_cpu_profile_tensors_take_the_plain_version(rng):
    pa, pb, la, lb = (torch.from_numpy(x) for x in _profiles(rng, 4, 16, 16))
    sub = torch.from_numpy(dp.HOXD70.copy())
    before = dict(gotoh_cuda.LAUNCHES)
    for normalize in (False, True):
        s1, d1 = gotoh_cuda.gotoh_forward_profiles(
            pa.float(), pb.float(), la, lb, sub, GO, GE, normalize
        )
        s2, d2 = dp.gotoh_forward_profiles_ref(pa.float(), pb.float(), la, lb, sub, GO, GE, normalize)
        assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert gotoh_cuda.LAUNCHES == before


def test_profile_wrapper_refuses_other_devices():
    z = torch.zeros((1, 4, 5), device="meta")
    n = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no Gotoh kernel"):
        gotoh_cuda.gotoh_forward_profiles(z, z, n, n, torch.zeros((5, 5), device="meta"), GO, GE)
