"""The random contents scripts/gotoh_replay.py draws for the kernel checks
and for a recorded launch (random_batch, random_profile_batch): padding
past each length, at most nine rows a profile cell, related even
problems, the edge-case lengths, any batch size drawn at once."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import gotoh_replay  # noqa: E402

torch.set_num_threads(1)


def _padded(c, lens, side, pad):
    live = np.arange(side)[None, :] < lens[:, None]
    return (c[~live] == pad).all(), live


def test_replay_contents_keep_the_recorded_lengths():
    rng = np.random.default_rng(5)
    B, M, N = 3001, 64, 48
    la = rng.integers(0, M + 1, size=B).astype(np.int32)
    lb = rng.integers(0, N + 1, size=B).astype(np.int32)
    la[:3], lb[:3] = (0, M, 5), (0, N, 0)
    x = gotoh_replay.device_inputs(rng, {"kernel": "gotoh_forward_profiles", "lens_a": la,
                                         "lens_b": lb, "M": M, "N": N, "B": B}, "cpu")
    pa, pb = x[0].numpy(), x[1].numpy()
    assert pa.shape == (B, M, 5) and pb.shape == (B, N, 5) and x[0].dtype == torch.float32
    assert np.array_equal(x[2].numpy(), la) and np.array_equal(x[3].numpy(), lb)
    for p, lens, side in ((pa, la, M), (pb, lb, N)):
        padded, live = _padded(p, lens, side, 0)
        assert padded
        assert p[live].sum(axis=1).max() <= 9 and p.sum() > 0
    ca, cb, la2, lb2 = gotoh_replay.random_batch(rng, B, M, (la, lb), N)
    assert np.array_equal(la2, la) and np.array_equal(lb2, lb)
    for c, lens, side in ((ca, la, M), (cb, lb, N)):
        padded, live = _padded(c, lens, side, 255)
        assert padded and (c[live] <= 4).all()
    assert (cb[cb < 255] < 4).all()  # ambiguity codes on the a side only
    # even problems: b is a repeated to lb with 15% substitutions
    both = (np.arange(B)[:, None] % 2 == 0) & (np.arange(N)[None, :] < np.minimum(la, lb)[:, None])
    same = (ca[:, :N] == cb)[both & (ca[:, :N] < 4)].mean()
    assert 0.8 < same < 0.95
    odd = (np.arange(B)[:, None] % 2 == 1) & (np.arange(N)[None, :] < np.minimum(la, lb)[:, None])
    assert 0.15 < (ca[:, :N] == cb)[odd & (ca[:, :N] < 4)].mean() < 0.35


def test_checked_batches_draw_lengths_and_edge_cases():
    rng = np.random.default_rng(2024)
    B, side = 64, 256
    ca, cb, la, lb = gotoh_replay.random_batch(rng, B, side)
    edges = [(1, 1), (0, 5), (7, 0), (0, 0), (side, side)]
    assert [(int(x), int(y)) for x, y in zip(la[:5], lb[:5])] == edges
    assert ((la[5:] >= 1) & (la[5:] <= side)).all() and ((lb[5:] >= 1) & (lb[5:] <= side)).all()
    for c, lens in ((ca, la), (cb, lb)):
        padded, live = _padded(c, lens, side, 255)
        assert padded and (c[live] <= 4).all()
    # b repeats a past la: position j of b draws on a[j % la]
    k = next(k for k in range(6, B, 2) if lb[k] > 2 * la[k] > 0)
    rep = ca[k, np.arange(lb[k]) % la[k]]
    assert ((rep == cb[k, :lb[k]]) | (rep == 4)).mean() > 0.8
    pa, pb, pla, plb = gotoh_replay.random_profile_batch(np.random.default_rng(2025), 10, 4096)
    assert pa.dtype == np.uint8 and pa.shape == (10, 4096, 5) and pb.shape == (10, 4096, 5)
    for p, lens in ((pa, pla), (pb, plb)):
        padded, live = _padded(p, lens, 4096, 0)
        rows = p[live].sum(axis=1)
        assert padded and rows.max() <= 9 and (rows > 0).mean() > 0.9
