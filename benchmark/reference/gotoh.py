"""Plain PyTorch global alignment with affine gaps (Gotoh), batched.

The scoring the program states for its gapped closure: HOXD70 substitution
scores over A, C, G, T (any other letter scores as the fifth row), and a gap
of length k costs GAP_OPEN + k * GAP_EXTEND.  ``best_scores`` gives each
problem's optimal score; ``walk`` also walks back one optimal path and
returns its columns.  Both run over anti-diagonals with the whole diagonal
as one vector, in the dtype given: float32 is exact for these integer
scores, and a lower precision is the control the check must fail.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

HOXD70 = np.array(
    [[91, -114, -31, -123, -44],
     [-114, 100, -125, -31, -44],
     [-31, -125, 100, -114, -44],
     [-123, -31, -114, 91, -44],
     [-44, -44, -44, -44, -44]], np.float64)
GAP_OPEN = -400.0
GAP_EXTEND = -30.0
NEG = -1e9
# column kinds of an alignment
DIAG, A_ONLY, B_ONLY = 0, 1, 2
_CODE = np.full(256, 4, np.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i


def codes(text: np.ndarray) -> np.ndarray:
    return _CODE[text]


def _pad(seqs: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(seqs), width), 4, np.int64)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = codes(s)
    return out


def _forward(la_h, lb_h, cell_scores, dtype, device, keep_decisions: bool):
    """The recurrence over anti-diagonals.  cell_scores(jm1) -> [B, M+1]
    substitution scores of the cells (lane i, j) in `dtype`, jm1 = j - 1
    clamped into [0, N - 1]."""
    B = len(la_h)
    M = max(int(max(la_h)), 1)
    N = max(int(max(lb_h)), 1)
    la = torch.as_tensor(np.asarray(la_h), device=device).long()
    lb = torch.as_tensor(np.asarray(lb_h), device=device).long()
    go_ge = torch.tensor(GAP_OPEN + GAP_EXTEND, dtype=dtype, device=device)
    ge = torch.tensor(GAP_EXTEND, dtype=dtype, device=device)
    neg = torch.tensor(NEG, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    lane = torch.arange(M + 1, device=device)
    negs = torch.full((B, M + 1), NEG, dtype=dtype, device=device)
    H1 = torch.where(lane == 0, zero, neg).expand(B, M + 1)
    H2, E1, F1 = negs, negs, negs
    neg_col = torch.full((B, 1), NEG, dtype=dtype, device=device)
    d_final = la + lb
    score = torch.where(d_final == 0, zero, neg)
    decisions = []
    for d in range(1, M + N + 1):
        j = d - lane
        live = (j >= 0) & (j <= N)
        e_h = H1 + go_ge
        e_e = E1 + ge
        E = torch.where(live & (j >= 1), torch.maximum(e_h, e_e), neg)
        f_h = torch.cat([neg_col, H1[:, :-1]], 1) + go_ge
        f_f = torch.cat([neg_col, F1[:, :-1]], 1) + ge
        F = torch.where(live & (lane >= 1), torch.maximum(f_h, f_f), neg)
        s = cell_scores((j - 1).clamp(0, N - 1))
        diag = torch.cat([neg_col, H2[:, :-1]], 1) + s
        diag = torch.where(live & (lane >= 1) & (j >= 1), diag, neg)
        H = torch.maximum(diag, torch.maximum(F, E))
        if keep_decisions:
            src = torch.where(diag >= torch.maximum(F, E), 0, torch.where(F >= E, 1, 2))
            dec = src | ((e_h >= e_e).long() << 2) | ((f_h >= f_f).long() << 3)
            decisions.append(dec.to(torch.uint8))
        hit = d_final == d
        if bool(hit.any()):
            score = torch.where(hit, H.gather(1, la[:, None])[:, 0], score)
        H2, H1, E1, F1 = H1, H, E, F
    return score, decisions


def code_scores(a_seqs, b_seqs, dtype, device):
    """cell_scores of ASCII sequence pairs: HOXD70 looked up by code."""
    M = max(max(len(s) for s in a_seqs), 1)
    N = max(max(len(s) for s in b_seqs), 1)
    return code_array_scores(_pad(a_seqs, M), _pad(b_seqs, N), dtype, device)


def code_array_scores(a, b, dtype, device):
    """cell_scores of code arrays ([B, M] and [B, N], codes 0-3 for A, C,
    G, T and 4 or more for anything else)."""
    a = torch.as_tensor(np.minimum(np.asarray(a, np.int64), 4), device=device)
    b = torch.as_tensor(np.minimum(np.asarray(b, np.int64), 4), device=device)
    B = a.shape[0]
    S = torch.tensor(HOXD70, dtype=dtype, device=device)
    a_lane = torch.cat([torch.full((B, 1), 4, dtype=torch.long, device=device), a], 1)
    rows = S[a_lane]
    return lambda jm1: rows.gather(2, b[:, jm1][:, :, None])[:, :, 0]


def profile_scores(pa, pb, normalize: bool, dtype, device):
    """cell_scores of count profiles ([B, M, 5] and [B, N, 5]): the
    expected substitution score pa[i-1] . HOXD70 . pb[j-1], each row first
    divided by its count total when `normalize`."""
    pa = torch.as_tensor(np.asarray(pa, np.float64), device=device)
    pb = torch.as_tensor(np.asarray(pb, np.float64), device=device)
    if normalize:
        pa = pa / pa.sum(-1, keepdim=True).clamp(min=1)
        pb = pb / pb.sum(-1, keepdim=True).clamp(min=1)
    B = pa.shape[0]
    q = (pa @ torch.tensor(HOXD70, dtype=torch.float64, device=device)).to(dtype)
    q = torch.cat([torch.zeros((B, 1, 5), dtype=dtype, device=device), q], 1)
    pb = pb.to(dtype)
    return lambda jm1: (q * pb[:, jm1]).sum(-1)


def best_scores(a_seqs, b_seqs, dtype=torch.float32, device="cpu") -> np.ndarray:
    """Optimal global score of each pair (a_seqs[k], b_seqs[k]) of ASCII
    arrays, each side non-empty."""
    score, _ = _forward([len(a) for a in a_seqs], [len(b) for b in b_seqs],
                        code_scores(a_seqs, b_seqs, dtype, device), dtype, device, False)
    return score.double().cpu().numpy()


def walk(la, lb, cell_scores, dtype, device) -> List[np.ndarray]:
    """The forward pass in `dtype` with its decisions, then one path of each
    problem walked back from (la, lb) to (0, 0); ties go to the diagonal,
    then the vertical gap, and to opening a gap."""
    _, decisions = _forward(la, lb, cell_scores, dtype, device, True)
    dec = torch.stack(decisions, 1).cpu().numpy()  # [B, D, M+1], diagonal d at d-1
    out = []
    for k in range(len(la)):
        i, j, state, cols = int(la[k]), int(lb[k]), 0, []
        while i > 0 or j > 0:
            v = int(dec[k, i + j - 1, i])
            if state == 0:
                state = {0: 0, 1: 1, 2: 2}[v & 3]
                if state == 0:
                    cols.append(DIAG)
                    i, j = i - 1, j - 1
                continue
            if state == 1:  # a gap in B: consumes A
                cols.append(A_ONLY)
                state = 0 if v & 8 else 1
                i -= 1
            else:
                cols.append(B_ONLY)
                state = 0 if v & 4 else 2
                j -= 1
        out.append(np.array(cols[::-1], np.int8))
    return out


def path_scores(kinds: np.ndarray, a_codes: np.ndarray, b_codes: np.ndarray,
                piece: np.ndarray, n_pieces: int) -> np.ndarray:
    """Exact score of every piece of an alignment given column by column:
    kinds (DIAG / A_ONLY / B_ONLY), the codes of each row's base in a DIAG
    column, and each column's piece number (non-decreasing).  A gap run
    ends at a piece's edge."""
    diag = kinds == DIAG
    sub = np.zeros(len(kinds))
    sub[diag] = HOXD70[a_codes[diag], b_codes[diag]]
    gap = ~diag
    first = np.ones(len(kinds), bool)
    first[1:] = (kinds[1:] != kinds[:-1]) | (piece[1:] != piece[:-1])
    opens = gap & first
    per = sub + gap * GAP_EXTEND + opens * GAP_OPEN
    return np.bincount(piece, weights=per, minlength=n_pieces)

