"""The homology HMM's decode, judged problem by problem.

progressiveMauve's backbone rests on a two-state pair HMM (Homologous /
Unrelated) decoded over every pairwise projection of the alignment before
the backbone is applied; no output file holds that alignment, so the
harness records, during the untimed warm job, each batch of pairs the
program hands its decode (the code rows of each pair, their lengths) and
the bits it returned (P(Homologous) > threshold per column).  Here the
reference works the posterior out anew, in float64, and ``hmm_flips``
counts the columns where the program's bit differs.

The model, as the program states it (progressiveMauve's defaults): from the
genomes' GC content, the Homologous state emits a match with probability
0.7, transitions and transversions 2:1 out of the rest less a gap mass of
0.05; the Unrelated state a match at the background rate
2((gc/2)^2 + ((1-gc)/2)^2) of the 0.6 that is not gap, mismatches halved
between transitions and transversions, gaps at 0.4.  Emission probabilities
are float32 (the configuration's precision); the chain moves H -> U with
probability 1e-9 and U -> H with 1e-5, and starts at 0.5 / 0.5.  A column
is a match, a transition (A<->G, C<->T), a transversion, or a gap (either
side a gap or an N); a column where both sides are gaps is not part of the
pairwise projection: it carries the posterior of the live column before it
(the first live column's, before any).

The decode is forward-backward over 2x2 matrices, each step's
M[i, j] = trans[i, j] * emit_t[j] (the first live column's diag(emit)),
with inclusive prefix and suffix products by doubling, every product
rescaled to a largest entry of one.  It runs in any dtype: float64 for the
judgement, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

GO_HOMOLOGOUS = 1e-5
GO_UNRELATED = 1e-9
IDENTITY = 0.7
GAP_H = 0.05
GAP_U = 0.4
MATCH, TRANSITION, TRANSVERSION, GAP = 0, 1, 2, 3
_ACGT = np.full(256, 4, np.int64)
for _i, _c in enumerate(b"ACGT"):
    _ACGT[_c] = _i
    _ACGT[_c + 32] = _i


def gc_content(genomes) -> float:
    """GC share over the A, C, G and T bases of every genome (letters)."""
    gc = total = 0
    for g in genomes:
        counts = np.bincount(_ACGT[g], minlength=5)
        total += int(counts[:4].sum())
        gc += int(counts[1] + counts[2])
    return gc / total if total else 0.5


def emissions(gc: float) -> np.ndarray:
    """[4 symbols, 2 states] emission probabilities (float64)."""
    mism_h = max(1.0 - IDENTITY - GAP_H, 1e-6)
    emit_h = np.array([IDENTITY, mism_h * 2 / 3, mism_h / 3, GAP_H])
    p_bg = 2 * ((gc / 2) ** 2 + ((1 - gc) / 2) ** 2)
    mism_u = (1 - GAP_U) * (1 - p_bg)
    emit_u = np.array([p_bg * (1 - GAP_U), mism_u / 2, mism_u / 2, GAP_U])
    return np.stack([emit_h / emit_h.sum(), emit_u / emit_u.sum()], 1)


def _rescale(m):
    a, b, c, d = m
    top = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    top = torch.where(top > 0, top, torch.ones_like(top))
    return (a / top, b / top, c / top, d / top)


def _mul(x, y):
    xa, xb, xc, xd = x
    ya, yb, yc, yd = y
    return _rescale((xa * ya + xb * yc, xa * yb + xb * yd,
                     xc * ya + xd * yc, xc * yb + xd * yd))


def _prefix(m):
    """Inclusive prefix products P_t = M_0 ... M_t along axis 1."""
    T, s = m[0].shape[1], 1
    while s < T:
        head = [e[:, :-s] for e in m]
        tail = [e[:, s:] for e in m]
        prod = _mul(head, tail)
        m = tuple(torch.cat([e[:, :s], p], 1) for e, p in zip(m, prod))
        s *= 2
    return m


def _suffix(m):
    """Inclusive suffix products Q_t = M_t ... M_{T-1} along axis 1."""
    T, s = m[0].shape[1], 1
    while s < T:
        head = [e[:, :-s] for e in m]
        tail = [e[:, s:] for e in m]
        prod = _mul(head, tail)
        m = tuple(torch.cat([p, e[:, T - s:]], 1) for e, p in zip(m, prod))
        s *= 2
    return m


def posterior_h(ri, rj, lengths, emit, dtype, device):
    """P(Homologous) [B, T] of each pair of code rows (uint8 [B, T]: 0-3
    bases, 4 N, 5 gap), columns at or past `lengths` treated as absent."""
    ri = torch.as_tensor(np.asarray(ri), device=device).long()
    rj = torch.as_tensor(np.asarray(rj), device=device).long()
    B, T = ri.shape
    pad = torch.arange(T, device=device)[None, :] >= torch.as_tensor(
        np.asarray(lengths), device=device)[:, None]
    inert = ((ri == 5) & (rj == 5)) | pad
    base = (ri < 4) & (rj < 4)
    purine = (ri == 0) | (ri == 2)
    same_class = purine == ((rj == 0) | (rj == 2))
    sym = torch.where(~base, GAP, torch.where(ri == rj, MATCH,
                                              torch.where(same_class, TRANSITION, TRANSVERSION)))
    e = torch.as_tensor(np.asarray(emit, np.float32), device=device).to(dtype)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    e0 = torch.where(inert, one, e[sym, 0])
    e1 = torch.where(inert, one, e[sym, 1])
    live = ~inert
    first = live & (torch.cumsum(live.int(), 1) == 1)
    t = torch.tensor([[1 - GO_UNRELATED, GO_UNRELATED], [GO_HOMOLOGOUS, 1 - GO_HOMOLOGOUS]],
                     dtype=torch.float64).to(dtype)
    m = (torch.where(inert, one, torch.where(first, e0, t[0, 0] * e0)),
         torch.where(inert | first, zero, t[0, 1] * e1),
         torch.where(inert | first, zero, t[1, 0] * e0),
         torch.where(inert, one, torch.where(first, e1, t[1, 1] * e1)))
    pa, pb, pc, pd = _prefix(m)
    alpha0, alpha1 = 0.5 * (pa + pc), 0.5 * (pb + pd)
    qa, qb, qc, qd = _suffix(m)
    ones = torch.ones((B, 1), dtype=dtype, device=device)
    beta0 = torch.cat([(qa + qb)[:, 1:], ones], 1)
    beta1 = torch.cat([(qc + qd)[:, 1:], ones], 1)
    raw0, raw1 = alpha0 * beta0, alpha1 * beta1
    total = raw0 + raw1
    return torch.where(total > 0, raw0 / torch.where(total > 0, total, one), 0.5 * one)


def decode_bits(rows, ii, jj, lengths, threshold, emit, dtype, device, block_cells=1 << 24):
    """bool [B, T]: P(Homologous) > threshold for the pairs (ii, jj) of
    code rows `rows`, in blocks of pairs that fit."""
    rows = np.asarray(rows)
    ii, jj, lengths = np.asarray(ii), np.asarray(jj), np.asarray(lengths)
    B, T = len(ii), rows.shape[1]
    out = np.zeros((B, T), bool)
    step = max(1, block_cells // max(T, 1))
    for s in range(0, B, step):
        sl = slice(s, s + step)
        post = posterior_h(rows[ii[sl]], rows[jj[sl]], lengths[sl], emit, dtype, device)
        out[sl] = (post > threshold).cpu().numpy()
    return out


def judge_calls(calls, genomes, device):
    """(columns whose bit differs, counts) over every recorded decode."""
    emit = emissions(gc_content(genomes))
    flips = problems = columns = 0
    for call in calls:
        want = decode_bits(call["rows"], call["ii"], call["jj"], call["lengths"],
                           call["threshold"], emit, torch.float64, device)
        live = np.arange(want.shape[1])[None, :] < np.asarray(call["lengths"])[:, None]
        got = np.asarray(call["bits"])[:, :want.shape[1]]
        flips += int(np.sum((want != got) & live))
        problems += len(call["ii"])
        columns += int(np.sum(call["lengths"]))
    return flips, {"hmm_problems": problems, "hmm_columns": columns}
