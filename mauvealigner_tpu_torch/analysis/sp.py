"""Sum-of-pairs scoring of gapped alignments.

computeSPScore / computeMatchScores / computeGapScores equivalents
(reference call sites src/repeatoire.cpp:2511-2536, src/evd.cpp:29-31),
vectorized over alignment columns.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.ops import dp


def interval_column_codes(iv: Interval, genomes: Sequence[Genome]) -> np.ndarray:
    """[n_seqs, n_cols] int8 codes in match-space orientation; 5 = gap/absent."""
    out = np.full((iv.n_seqs, iv.n_cols), 5, np.int8)
    for s in range(iv.n_seqs):
        if iv.starts[s] == 0:
            continue
        length = int(iv.aln[s].sum())
        codes = genomes[s].sub_codes_signed(int(iv.starts[s]), length)
        out[s, iv.aln[s]] = np.minimum(codes, 4)
    return out


def match_and_gap_scores(
    col_codes: np.ndarray,
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
) -> Tuple[float, float]:
    """(substitution score, gap score) summed over all sequence pairs.

    The pairwise substitution sum is vectorized over columns via symbol
    counts: (m^T S m - sum_c n_c S_cc)/2 per column.  Gap-run opens are
    counted per sequence pair over the PAIRWISE PROJECTION (both-gap
    columns removed, so a run continues across them) — an O(k^2) loop over
    pairs, each O(T) vectorized.  Gap extensions reduce to the per-column
    count product n_gap*n_base (both-gap pairs contribute nothing, matching
    the projection).
    """
    k, T = col_codes.shape
    if T == 0 or k < 2:
        return 0.0, 0.0
    S5 = np.asarray(subst, dtype=np.float64)
    if T <= 4096:
        # one scatter pass beats 5 compare passes at call-overhead scale
        flat = np.arange(T, dtype=np.int64) * 6 + col_codes
        counts = np.bincount(flat.ravel(), minlength=T * 6).reshape(T, 6)[:, :5].T
    else:
        counts = np.zeros((5, T), np.int64)
        for c in range(5):
            counts[c] = (col_codes == c).sum(axis=0)
    term1 = np.einsum("ct,cd,dt->t", counts, S5, counts)
    term2 = np.einsum("ct,c->t", counts, np.diag(S5))
    match_score = float(((term1 - term2) / 2).sum())

    gapped = col_codes == 5
    n_gap = gapped.sum(axis=0)
    n_base = k - n_gap
    gap_positions = int((n_gap * n_base).sum())
    # gap-run starts per ordered pair, with both-gap columns projected out
    # (the pairwise projection the reference scores): a gap run of x against
    # y continues across columns where y is also gapped.
    run_starts = 0
    if T <= 4096:
        # small alignments (refinement windows, repeat families) are numpy
        # call-overhead bound: batch all pairs into [pairs, T] arrays.  A
        # kept gap column starts a run iff the nearest kept column to its
        # left (cummax of kept column indices) is not a gap of the same
        # sequence.
        ii, jj = np.triu_indices(k, 1)
        A = gapped[ii]
        B = gapped[jj]
        nonskip = ~(A & B)
        # packed-code running max: (col index, gapA, gapB) of the nearest
        # kept column to the left, with no gather passes (see the batch
        # variant below)
        code = np.where(
            nonskip,
            (np.arange(T, dtype=np.int32) << 2)[None, :]
            | (A.astype(np.int32) << 1)
            | B.astype(np.int32),
            np.int32(-1),
        )
        cm = np.maximum.accumulate(code, axis=1)
        prev_code = np.empty_like(cm)
        prev_code[:, 0] = -1
        prev_code[:, 1:] = cm[:, :-1]
        has_prev = prev_code >= 0
        pA = has_prev & ((prev_code & 2) != 0)
        pB = has_prev & ((prev_code & 1) != 0)
        run_starts += int(((A & nonskip) & ~pA).sum())
        run_starts += int(((B & nonskip) & ~pB).sum())
    else:
        # long alignments are bandwidth-bound: sequential boolean passes per
        # pair beat the batched gather
        for i in range(k):
            gi = gapped[i]
            for j in range(i + 1, k):
                gj = gapped[j]
                keep = ~(gi & gj)
                for g in (gi[keep], gj[keep]):
                    if not g.any():
                        continue
                    starts = g.copy()
                    starts[1:] &= ~g[:-1]
                    run_starts += int(starts.sum())
    gap_score = run_starts * gap_open + gap_positions * gap_extend
    return match_score, gap_score


def match_and_gap_scores_batch(
    mats: Sequence[np.ndarray],
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
    max_lane_cells: int = 1 << 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched match_and_gap_scores over many [k_f, T_f] int8 code matrices;
    returns (match_scores [F], gap_scores [F]) float64.

    Matrices group by (row count, padded column bucket); column padding uses
    code 5 (all-gap), which is score-neutral: padded columns add no symbol
    counts, n_base = 0 kills the extension product, and both-gap pair
    columns are projected out of the run-start scan.  `max_lane_cells`
    bounds the (family*pair, columns) work arrays per slab — sized so the
    int32 scan arrays stay cache-resident instead of streaming DRAM (a
    16M-cell slab ran 9x slower than cache-sized slabs on the same work)."""
    F = len(mats)
    ms = np.zeros(F, np.float64)
    gs = np.zeros(F, np.float64)
    S5 = np.asarray(subst, dtype=np.float64)
    diag = np.diag(S5)
    groups: dict = {}
    for f, X in enumerate(mats):
        k, T = X.shape
        if T == 0 or k < 2:
            continue
        # oversized matrices (long alignments, or so many pairs that even a
        # one-matrix slab blows the cache budget) keep the sequential
        # per-matrix path — batching exists to amortize call overhead, which
        # a matrix this large does not suffer from
        if T > 4096 or (k * (k - 1) // 2) * T > max_lane_cells:
            ms[f], gs[f] = match_and_gap_scores(X, subst, gap_open, gap_extend)
            continue
        # multiple-of-64 column buckets: all-host arrays, so fine buckets
        # cost nothing and cap padding waste at <64 columns
        Tb = max(16, -(-T // 64) * 64)
        groups.setdefault((k, Tb), []).append(f)
    for (k, Tb), idxs in groups.items():
        P = k * (k - 1) // 2
        slab = max(1, max_lane_cells // max(P * Tb, 1))
        ii, jj = np.triu_indices(k, 1)
        for off in range(0, len(idxs), slab):
            chunk = np.asarray(idxs[off : off + slab], np.int64)
            Fg = len(chunk)
            X = np.full((Fg, k, Tb), 5, np.int8)
            for n, f in enumerate(chunk):
                X[n, :, : mats[f].shape[1]] = mats[f]
            base = (np.arange(Fg, dtype=np.int64)[:, None] * Tb + np.arange(Tb)[None, :]) * 6
            flat = base[:, None, :] + X
            counts = (
                np.bincount(flat.ravel(), minlength=Fg * Tb * 6)
                .reshape(Fg, Tb, 6)[..., :5]
                .astype(np.float64)
            )
            term1 = np.einsum("ftc,cd,ftd->f", counts, S5, counts)
            term2 = np.einsum("ftc,c->f", counts, diag)
            ms[chunk] = (term1 - term2) / 2
            gapped = X == 5
            n_gap = gapped.sum(axis=1)
            gap_positions = (n_gap * (k - n_gap)).sum(axis=1)
            A = gapped[:, ii, :].reshape(Fg * P, Tb)
            B = gapped[:, jj, :].reshape(Fg * P, Tb)
            nonskip = ~(A & B)
            # pack (column index, gapA, gapB) of kept columns into one int32:
            # a single running max then carries the previous kept column's gap
            # bits to every position — no gather passes
            code = np.where(
                nonskip,
                (np.arange(Tb, dtype=np.int32) << 2)[None, :]
                | (A.astype(np.int32) << 1)
                | B.astype(np.int32),
                np.int32(-1),
            )
            cm = np.maximum.accumulate(code, axis=1)
            prev_code = np.empty_like(cm)
            prev_code[:, 0] = -1
            prev_code[:, 1:] = cm[:, :-1]
            has_prev = prev_code >= 0
            pA = has_prev & ((prev_code & 2) != 0)
            pB = has_prev & ((prev_code & 1) != 0)
            run_starts = ((A & nonskip) & ~pA).sum(axis=1).astype(np.int64)
            run_starts += ((B & nonskip) & ~pB).sum(axis=1)
            gs[chunk] = (
                run_starts.reshape(Fg, P).sum(axis=1) * gap_open
                + gap_positions * gap_extend
            )
    return ms, gs


def compute_sp_score(
    iv: Interval,
    genomes: Sequence[Genome],
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
) -> float:
    m, g = match_and_gap_scores(interval_column_codes(iv, genomes), subst, gap_open, gap_extend)
    return m + g
