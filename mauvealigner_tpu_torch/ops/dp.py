"""K3: batched affine-gap DP (Gotoh) drivers and their plain-torch versions.

Port of mauvealigner_tpu/ops/dp.py, the replacement for the libMUSCLE
subprocess the reference forks per inter-anchor region
(MuscleInterface::Align, src/MatchRecord.h:311, src/mauveAligner.cpp:82-83).
Regions are bucketed by length, batched, and aligned on the device: the
forward pass and the traceback are the CUDA kernels of ops/gotoh_cuda.py on
a CUDA tensor, and the plain-torch functions below on a CPU tensor.

The recurrence runs over anti-diagonals with the whole diagonal as one
vector; each cell stores 4 decision bits: bits 0-1 the H source (0 diag,
1 up/F, 2 left/E), bit 2 E opened from H, bit 3 F opened from H.  The
decision array is laid out by diagonal, dec[b, d, i] = cell (i, d - i).
Traceback emits an op string (1 = diag, 2 = up/consume-A, 3 =
left/consume-B), end of alignment first.

Gap model: a gap of length k costs gap_open + k*gap_extend (both negative).
Tie-breaking is deterministic: diagonal > up > left; gap-open wins ties over
gap-extend.  The substitution score of a cell is computed per cell (looked up
from the codes, or (pA[i-1] . SUBST) . pB[j-1] for count profiles), so no
[B, M, N] score matrix is built, and everything accumulates in f32:
HOXD-class integer scores over uint8 counts are exact.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

NEG = -1e9  # exactly representable in f32

OP_NONE, OP_DIAG, OP_UP, OP_LEFT = 0, 1, 2, 3

# HOXD70 substitution scores (Chiaromonte/Yap/Miller 2002), the matrix behind
# the reference's hoxd scoring scheme (PairwiseScoringScheme / hoxd_matrix,
# src/repeatoire.cpp:1994, src/evd.cpp:29-31).  Fifth row/col handles
# ambiguity codes (never a good match).
HOXD70 = np.array(
    [
        [91, -114, -31, -123, -44],
        [-114, 100, -125, -31, -44],
        [-31, -125, 100, -114, -44],
        [-123, -31, -114, 91, -44],
        [-44, -44, -44, -44, -44],
    ],
    dtype=np.float32,
)

DEFAULT_GAP_OPEN = -400.0
DEFAULT_GAP_EXTEND = -30.0


def read_substitution_matrix(path: str) -> np.ndarray:
    """NCBI-format substitution matrix file -> [5, 5] float32.

    Parity with readSubstitutionMatrix / --substitution-matrix
    (src/progressiveMauve.cpp:666-687): '#' comments, a header row of
    residue symbols, then one row per residue.  A/C/G/T columns map to codes
    0-3; every other symbol (N, ambiguity codes, '*') folds into the
    ambiguity row/column 4 as the minimum of the contributing scores.
    """
    order = {"A": 0, "C": 1, "G": 2, "T": 3}
    header: List[str] = []
    out = np.full((5, 5), np.nan, np.float32)
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            if not header:
                header = [f.upper() for f in fields]
                continue
            sym = fields[0].upper()
            scores = [float(x) for x in fields[1 : len(header) + 1]]
            i = order.get(sym, 4)
            for col_sym, val in zip(header, scores):
                j = order.get(col_sym, 4)
                if np.isnan(out[i, j]) or val < out[i, j]:
                    out[i, j] = val
    if np.isnan(out[:4, :4]).any():
        raise ValueError(f"substitution matrix {path!r} is missing A/C/G/T entries")
    # missing ambiguity entries default to the worst ACGT mismatch
    fallback = out[:4, :4].min()
    out = np.where(np.isnan(out), fallback, out)
    return out.astype(np.float32)


def one_hot_profile(codes: np.ndarray, length: int) -> np.ndarray:
    """codes int array -> [length, 5] one-hot profile, zero-padded."""
    out = np.zeros((length, 5), dtype=np.float32)
    n = min(len(codes), length)
    if n:
        out[np.arange(n), np.minimum(codes[:n], 4)] = 1.0
    return out


def gap_scalars(gap_open: float, gap_extend: float) -> Tuple[float, float]:
    """(gap_open + gap_extend, gap_extend), each rounded to f32 and the sum
    taken in f32, as the JAX package computes them."""
    go, ge = np.float32(gap_open), np.float32(gap_extend)
    return float(go + ge), float(ge)


def _subst6(subst: torch.Tensor) -> torch.Tensor:
    """[5, 5] -> [6, 6] f32 with a zero row and column for padding codes."""
    out = torch.zeros((6, 6), dtype=torch.float32, device=subst.device)
    out[:5, :5] = subst.to(torch.float32)
    return out


def _gotoh_forward_ref(B, M, N, lens_a, lens_b, gap_open, gap_extend, dev, live_scores):
    """The recurrence both plain versions share.  live_scores(j, live) ->
    [B, M+1] f32 substitution scores of the cells (lane, j) on one
    anti-diagonal, read only where `live` (1 <= j <= N); lane 0 scores NEG
    and off-band cells 0, as the CUDA kernels do."""
    go_ge, ge = gap_scalars(gap_open, gap_extend)
    lane = torch.arange(M + 1, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)
    H_prev = torch.where(lane == 0, 0.0, neg).expand(B, M + 1)
    H_prev2 = torch.full((B, M + 1), NEG, dtype=torch.float32, device=dev)
    E_prev = H_prev2
    F_prev = H_prev2
    d_final = lens_a.long() + lens_b.long()
    la = lens_a.long()[:, None]
    score = torch.where(d_final == 0, 0.0, neg)
    dec = torch.empty((B, M + N + 1, M + 1), dtype=torch.uint8, device=dev)
    dec[:, 0] = 0
    for d in range(1, M + N + 1):
        j = d - lane
        e_from_h = H_prev + go_ge
        e_from_e = E_prev + ge
        e_open = e_from_h >= e_from_e
        E = torch.where(j >= 1, torch.maximum(e_from_h, e_from_e), neg)

        f_from_h = torch.cat([neg_col, H_prev[:, :-1]], dim=1) + go_ge
        f_from_f = torch.cat([neg_col, F_prev[:, :-1]], dim=1) + ge
        f_open = f_from_h >= f_from_f
        F = torch.where(lane >= 1, torch.maximum(f_from_h, f_from_f), neg)

        live = (j >= 1) & (j <= N)
        s = torch.where(lane == 0, neg, torch.where(live, live_scores(j, live), 0.0))
        Hd = torch.cat([neg_col, H_prev2[:, :-1]], dim=1) + s

        # priority diag > up(F) > left(E); strict > keeps the earlier choice
        better_f = F > Hd
        best = torch.where(better_f, F, Hd)
        choice = better_f.to(torch.uint8)
        better_e = E > best
        best = torch.where(better_e, E, best)
        choice = torch.where(better_e, 2, choice)
        dec[:, d] = choice | (e_open.to(torch.uint8) << 2) | (f_open.to(torch.uint8) << 3)
        score = torch.where(d_final == d, best.gather(1, la)[:, 0], score)
        H_prev2, H_prev, E_prev, F_prev = H_prev, best, E, F
    return score, dec


def gotoh_forward_codes_ref(
    codes_a: torch.Tensor,  # uint8 [B, M], padding >= 5
    codes_b: torch.Tensor,  # uint8 [B, N]
    lens_a: torch.Tensor,   # int32 [B]
    lens_b: torch.Tensor,   # int32 [B]
    subst: torch.Tensor,    # f32 [5, 5]
    gap_open: float,
    gap_extend: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch Gotoh forward pass over anti-diagonals: what the JAX
    package's _gotoh_core computes for one-hot code inputs.

    Returns (scores [B] f32 = H[mA, mB], 0 when mA + mB == 0;
    dec [B, M+N+1, M+1] uint8).  Cells outside the live band use a zero
    substitution score; the traceback never reads them."""
    B, M = codes_a.shape
    N = codes_b.shape[1]
    dev = codes_a.device
    sub = _subst6(subst).reshape(-1)
    # lane i reads code a[i-1]; lane 0 has none
    a_idx = torch.cat(
        [torch.full((B, 1), 5, dtype=torch.int64, device=dev), codes_a.long().clamp(max=5)],
        dim=1,
    ) * 6
    # column N of b_pad is the padding code read off the band
    b_pad = torch.cat(
        [codes_b.long().clamp(max=5), torch.full((B, 1), 5, dtype=torch.int64, device=dev)],
        dim=1,
    )

    def live_scores(j, live):
        return sub[a_idx + b_pad[:, torch.where(live, j - 1, N)]]

    return _gotoh_forward_ref(B, M, N, lens_a, lens_b, gap_open, gap_extend, dev, live_scores)


def normalize_profiles(p: torch.Tensor) -> torch.Tensor:
    """p / max(sum of the row, 1) per [.., 5] row, the row sum taken left to
    right: the JAX package's normalize (mean pairwise substitution scoring);
    the CUDA kernel computes the same expression in the same order."""
    total = p[..., 0]
    for k in range(1, 5):
        total = total + p[..., k]
    return p / torch.clamp(total, min=1.0)[..., None]


def profile_row_scores(p: torch.Tensor, subst: torch.Tensor) -> torch.Tensor:
    """q = p . SUBST per [.., 5] row, summed over the profile lanes in order
    0..4 with a rounding after every product and sum (no fused
    multiply-add), as the CUDA kernel computes it."""
    sub = subst.to(torch.float32)
    q = p[..., 0:1] * sub[0]
    for m in range(1, 5):
        q = q + p[..., m : m + 1] * sub[m]
    return q


def gotoh_forward_profiles_ref(
    prof_a: torch.Tensor,  # f32 [B, M, 5], rows beyond lens_a are zero
    prof_b: torch.Tensor,  # f32 [B, N, 5]
    lens_a: torch.Tensor,  # int32 [B]
    lens_b: torch.Tensor,  # int32 [B]
    subst: torch.Tensor,   # f32 [5, 5]
    gap_open: float,
    gap_extend: float,
    normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch Gotoh forward pass over profiles: what the JAX package's
    gotoh_forward_scored computes.  The cell score is
    s(i, j) = q_i . pB[j-1] with q_i = pA[i-1] . SUBST (profile_row_scores),
    summed over lanes 0..4 in order with no fused multiply-add; normalize
    first divides every profile row by its count total (normalize_profiles).
    Outputs as gotoh_forward_codes_ref."""
    B, M, _ = prof_a.shape
    N = prof_b.shape[1]
    dev = prof_a.device
    pa = prof_a.to(torch.float32)
    pb = prof_b.to(torch.float32)
    if normalize:
        pa = normalize_profiles(pa)
        pb = normalize_profiles(pb)
    # lane i owns q_i; lane 0 has none (its score is NEG)
    q = torch.cat(
        [torch.zeros((B, 1, 5), dtype=torch.float32, device=dev), profile_row_scores(pa, subst)],
        dim=1,
    )
    # row N of pb_pad is a zero row read off the band
    pb_pad = torch.cat([pb, torch.zeros((B, 1, 5), dtype=torch.float32, device=dev)], dim=1)

    def live_scores(j, live):
        pbj = pb_pad[:, torch.where(live, j - 1, N)]  # [B, M+1, 5]
        s = q[..., 0] * pbj[..., 0]
        for k in range(1, 5):
            s = s + q[..., k] * pbj[..., k]
        return s

    return _gotoh_forward_ref(B, M, N, lens_a, lens_b, gap_open, gap_extend, dev, live_scores)


def live_cell_mask(
    lens_a: torch.Tensor,  # int32 [B]
    lens_b: torch.Tensor,  # int32 [B]
    M: int,
    N: int,
) -> torch.Tensor:
    """bool [B, M+N+1, M+1]: True exactly at dec[b, i+j, i] for
    0 <= i <= la, 0 <= j <= lb, the cells a problem's score and traceback
    depend on and the only ones the CUDA forward kernels write."""
    dev = lens_a.device
    d = torch.arange(M + N + 1, device=dev)[None, :, None]
    i = torch.arange(M + 1, device=dev)[None, None, :]
    j = d - i
    return (i <= lens_a.long()[:, None, None]) & (j >= 0) & (j <= lens_b.long()[:, None, None])


def gotoh_traceback_ref(
    dec: torch.Tensor,     # uint8 [B, M+N+1, M+1]
    lens_a: torch.Tensor,  # int32 [B]
    lens_b: torch.Tensor,  # int32 [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch traceback: what the JAX package's gotoh_traceback
    computes.  Walks each problem from (mA, mB) to (0, 0) with an H/F/E
    mode state.  Returns (ops [B, M+N] uint8 end-first, OP_NONE after the
    walk ends; counts [B] int32)."""
    B, n_diags, W = dec.shape
    L = n_diags - 1
    dev = dec.device
    dec_flat = dec.reshape(B, -1)
    i = lens_a.long()
    j = lens_b.long()
    mode = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    # a walk on a forward pass's decisions ends within la + lb steps; one
    # that garbage bytes lead past the origin goes on, as the JAX scan's
    # does, for at most L steps in all
    settled = int((i + j).max()) if B else 0
    for t in range(L):
        active = (i > 0) | (j > 0)
        if t >= settled and not bool(active.any()):
            break
        idx = ((i + j) * W + i).clamp(0, n_diags * W - 1)
        byte = dec_flat.gather(1, idx[:, None])[:, 0].long()
        from_h = torch.where(i == 0, 2, torch.where(j == 0, 1, byte & 3))
        # c is 0 diag, 1 up, 2 left, or 3 (a source no forward pass writes),
        # which the JAX scan emits as left, steps as diag and leaves in E
        c = torch.where(mode == 0, from_h, mode)
        ops[:, t] = torch.where(active, c.clamp(max=2) + 1, OP_NONE).to(torch.uint8)
        opened = torch.where(c == 1, (byte >> 3) & 1, (byte >> 2) & 1)
        nmode = torch.where((c == 0) | (opened == 1), 0, c.clamp(max=2))
        i = torch.where(active & (c != 2), i - 1, i)
        j = torch.where(active & (c != 1), j - 1, j)
        mode = torch.where(active, nmode, mode)
    counts = (ops != OP_NONE).sum(dim=1, dtype=torch.int32)
    return ops, counts


def align_code_pairs_batch_async(
    codes_a: np.ndarray,  # uint8 [B, M], pad with 255
    codes_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    device="cuda",
):
    """Launch a batched sequence-pair alignment on `device`; returns a
    zero-arg fetch() -> (list of op arrays in start-to-end order, scores
    [B]).  Launches are asynchronous on a CUDA device; fetch() blocks."""
    from mauvealigner_tpu_torch.ops import gotoh_cuda  # imports this module
    from mauvealigner_tpu_torch.utils import timing

    B, M = codes_a.shape
    N = codes_b.shape[1]
    la_h = np.asarray(lens_a, np.int32)
    lb_h = np.asarray(lens_b, np.int32)
    if B and (la_h.min() < 0 or lb_h.min() < 0 or la_h.max() > M or lb_h.max() > N):
        raise ValueError(f"lengths must lie in [0, {M}] x [0, {N}]")
    timing.GLOBAL.add("dp_cells", float(B) * M * N)
    timing.GLOBAL.add("dp_calls", 1.0)
    gotoh_cuda.LAUNCH_SHAPES.append(dict(
        kernel="gotoh_forward_codes", M=M, N=N, B=B, lens_a=la_h.copy(), lens_b=lb_h.copy(),
        normalize=False,
    ))
    ca = torch.from_numpy(np.ascontiguousarray(codes_a, np.uint8)).to(device)
    cb = torch.from_numpy(np.ascontiguousarray(codes_b, np.uint8)).to(device)
    la = torch.from_numpy(la_h).to(device)
    lb = torch.from_numpy(lb_h).to(device)
    sub = torch.from_numpy(np.asarray(subst, np.float32).copy()).to(device)
    scores, dec = gotoh_cuda.gotoh_forward_codes(ca, cb, la, lb, sub, gap_open, gap_extend)
    ops, counts = gotoh_cuda.gotoh_traceback(dec, la, lb)
    del dec  # the decision bytes are dead once the traceback is queued

    def fetch():
        ops_h = ops.cpu().numpy()
        cnt = counts.cpu().numpy()
        out = [ops_h[b, : cnt[b]][::-1].copy() for b in range(B)]
        return out, scores.cpu().numpy()

    return fetch


def align_code_pairs_batch(
    codes_a: np.ndarray,  # uint8 [B, M], pad with 255
    codes_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    device="cuda",
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Blocking align_code_pairs_batch_async."""
    return align_code_pairs_batch_async(
        codes_a, codes_b, lens_a, lens_b, subst, gap_open, gap_extend, device
    )()


def align_profiles_batch_async(
    profiles_a: np.ndarray,  # [B, M, 5] uint8 counts (or float32), zero rows past lens_a
    profiles_b: np.ndarray,  # [B, N, 5]
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    normalize: bool = False,
    device="cuda",
):
    """Launch a batched profile-pair alignment on `device`; returns a
    zero-arg fetch() -> (list of op arrays in start-to-end order, scores
    [B]).  uint8 count profiles are copied as bytes and widened to f32 on
    the device.  normalize=True scores the mean pairwise substitution (each
    profile row divided by its count total on the device) — the
    profile-aware mode whose score scale matches plain code alignment."""
    from mauvealigner_tpu_torch.ops import gotoh_cuda  # imports this module
    from mauvealigner_tpu_torch.utils import timing

    B, M, _ = profiles_a.shape
    N = profiles_b.shape[1]
    la_h = np.asarray(lens_a, np.int32)
    lb_h = np.asarray(lens_b, np.int32)
    if B and (la_h.min() < 0 or lb_h.min() < 0 or la_h.max() > M or lb_h.max() > N):
        raise ValueError(f"lengths must lie in [0, {M}] x [0, {N}]")
    timing.GLOBAL.add("dp_cells", float(B) * M * N)
    timing.GLOBAL.add("dp_calls", 1.0)
    gotoh_cuda.LAUNCH_SHAPES.append(dict(
        kernel="gotoh_forward_profiles", M=M, N=N, B=B, lens_a=la_h.copy(), lens_b=lb_h.copy(),
        normalize=bool(normalize),
    ))

    def ship(p):
        if p.dtype != np.uint8:
            p = np.asarray(p, np.float32)
        return torch.from_numpy(np.ascontiguousarray(p)).to(device).to(torch.float32)

    pa, pb = ship(profiles_a), ship(profiles_b)
    la = torch.from_numpy(la_h).to(device)
    lb = torch.from_numpy(lb_h).to(device)
    sub = torch.from_numpy(np.asarray(subst, np.float32).copy()).to(device)
    scores, dec = gotoh_cuda.gotoh_forward_profiles(
        pa, pb, la, lb, sub, gap_open, gap_extend, normalize
    )
    ops, counts = gotoh_cuda.gotoh_traceback(dec, la, lb)
    del dec

    def fetch():
        ops_h = ops.cpu().numpy()
        cnt = counts.cpu().numpy()
        out = [ops_h[b, : cnt[b]][::-1].copy() for b in range(B)]
        return out, scores.cpu().numpy()

    return fetch


def align_profiles_batch(
    profiles_a: np.ndarray,
    profiles_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    normalize: bool = False,
    device="cuda",
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Blocking align_profiles_batch_async."""
    return align_profiles_batch_async(
        profiles_a, profiles_b, lens_a, lens_b, subst, gap_open, gap_extend,
        normalize, device,
    )()


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def dec_bytes(M: int, N: int) -> int:
    """Device bytes per problem of an M x N launch: the decision array.
    Above a block's shared memory the forward kernels also keep a slab row
    of bottom-row buffers and staged B side per problem (279,120 bytes at
    side 16384 against 536,920,065 of decisions), which this leaves out."""
    return (M + N + 1) * (M + 1)


def align_sequence_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_batch: int = 4096,
    memory_budget_bytes: int = 3 << 29,
    device="cuda",
) -> List[np.ndarray]:
    """Globally align many (codesA, codesB) pairs, bucketing by length.

    Returns per-pair op arrays.  Pairs longer than the largest bucket raise:
    callers cap region size (--max-gapped-aligner-length semantics,
    src/mauveAligner.cpp:675-676).  memory_budget_bytes bounds the decision
    bytes of one launch (default 1.5 GB).
    """
    results: List[np.ndarray] = [None] * len(pairs)  # type: ignore[list-item]
    groups: dict = {}
    for idx, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            # degenerate: pure gap alignment
            ops = np.concatenate(
                [np.full(len(a), OP_UP, np.uint8), np.full(len(b), OP_LEFT, np.uint8)]
            )
            results[idx] = ops
            continue
        if len(a) > buckets[-1] or len(b) > buckets[-1]:
            raise ValueError(
                f"region {idx} ({len(a)}x{len(b)}) exceeds the largest DP bucket {buckets[-1]}"
            )
        side = _bucket(max(len(a), len(b)), buckets)
        groups.setdefault(side, []).append(idx)
    pending = []  # (chunk, fetch): launch everything, then download
    for side, idxs in groups.items():
        bmax = max(1, min(max_batch, memory_budget_bytes // dec_bytes(side, side)))
        for off in range(0, len(idxs), bmax):
            chunk = idxs[off : off + bmax]
            ca = np.full((len(chunk), side), 255, np.uint8)
            cb = np.full((len(chunk), side), 255, np.uint8)
            la = np.zeros(len(chunk), np.int32)
            lb = np.zeros(len(chunk), np.int32)
            for k, idx in enumerate(chunk):
                a, b = pairs[idx]
                ca[k, : len(a)] = np.minimum(a, 4)
                cb[k, : len(b)] = np.minimum(b, 4)
                la[k], lb[k] = len(a), len(b)
            pending.append((chunk, align_code_pairs_batch_async(
                ca, cb, la, lb, subst, gap_open, gap_extend, device
            )))
    for chunk, fetch in pending:
        ops_list, _ = fetch()
        for k, idx in enumerate(chunk):
            results[idx] = ops_list[k]
    return results


def ops_to_gap_rows(ops: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Op string -> (rowA, rowB) boolean arrays (True = base, False = gap)."""
    row_a = (ops == OP_DIAG) | (ops == OP_UP)
    row_b = (ops == OP_DIAG) | (ops == OP_LEFT)
    return row_a, row_b
