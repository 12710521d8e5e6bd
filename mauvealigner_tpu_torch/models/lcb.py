"""LCB determination by breakpoint analysis + greedy breakpoint elimination.

Reproduces the libMems Aligner LCB machinery: `computeLCBAdjacencies_v2` and
the `LCB` adjacency struct (reused by the reference at src/sortContigs.cpp:55-58)
plus the greedy minimum-weight LCB removal loop of Aligner::align
(src/mauveAligner.cpp:668-698); LCB weight = sum of member match lengths,
threshold default seed_weight*3*seq_count (src/mauveAligner.cpp:648-656),
collinear mode eliminates down to a single LCB (LCB_size=-1 hack,
src/mauveAligner.cpp:664-666).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList


@dataclasses.dataclass
class LCB:
    """A located collinear block: an ordered run of anchors."""

    match_indices: np.ndarray  # indices into the MatchList, in seq-0 order
    weight: float  # length units by default; sp-score units under a scoring scheme
    # per-sequence signed extents: left/right coordinates of the block
    lefts: np.ndarray   # int64 [n_seqs] (0 where absent)
    rights: np.ndarray  # int64 [n_seqs]
    strands: np.ndarray  # int8 [n_seqs]: +1/-1/0


def _ranks_and_signs(ml: MatchList) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sequence order ranks (by |start|, among PRESENT matches only;
    absent components get rank -1) and strand signs of each match."""
    n, n_seqs = ml.starts.shape
    ranks = np.full((n, n_seqs), -1, np.int64)
    for g in range(n_seqs):
        present = np.nonzero(ml.starts[:, g] != NO_MATCH)[0]
        order = present[np.argsort(np.abs(ml.starts[present, g]), kind="stable")]
        ranks[order, g] = np.arange(len(order))
    signs = np.sign(ml.starts).astype(np.int8)
    return ranks, signs


def compute_lcb_boundaries(ml: MatchList) -> np.ndarray:
    """Partition full-multiplicity matches into collinear runs.

    Returns lcb_id per match (aligned with seq-0 order of ml; caller should
    pass a MatchList already sorted by sequence 0).  Two consecutive matches
    belong to the same LCB iff in every sequence they are directly adjacent
    with consistent orientation (computeLCBAdjacencies_v2 semantics).
    """
    n, n_seqs = ml.starts.shape
    if n == 0:
        return np.zeros(0, np.int64)
    ranks, signs = _ranks_and_signs(ml)
    # order by the first present sequence (seq-0-absent subset matches would
    # otherwise tie at |start| = 0 and interleave arbitrarily)
    keys = np.abs(ml.starts).astype(np.int64)
    keys[ml.starts == NO_MATCH] = np.iinfo(np.int64).max
    order0 = np.lexsort(tuple(keys[:, g] for g in range(n_seqs - 1, -1, -1)))
    inv0 = np.empty(n, np.int64)
    inv0[order0] = np.arange(n)
    # work in seq-0 order
    r = ranks[order0]
    s = signs[order0]
    brk = np.zeros(n, dtype=bool)
    brk[0] = True
    if n > 1:
        # same presence pattern and, for every present sequence, same strand
        # and directly-adjacent rank (ranks are within-presence; absent
        # components never contribute a break on rank, only on presence)
        same_sign = np.all(s[1:] == s[:-1], axis=1)  # includes presence (0)
        step = r[1:] - r[:-1]
        expected = s[1:].astype(np.int64)  # +1 fwd, -1 rev, 0 absent-absent
        both_present = (s[1:] != 0) & (s[:-1] != 0)
        adjacent = np.all(np.where(both_present, step == expected, True), axis=1)
        brk[1:] = ~(same_sign & adjacent)
    lcb_in_order0 = np.cumsum(brk) - 1
    return lcb_in_order0[inv0]


def build_lcbs(
    ml: MatchList, lcb_ids: np.ndarray, match_weights: np.ndarray | None = None
) -> List[LCB]:
    n, n_seqs = ml.starts.shape
    out: List[LCB] = []
    if n == 0:
        return out
    # member chain order must match compute_lcb_boundaries: first PRESENT
    # sequence primary (sorting by |seq-0 start| alone leaves seq-0-absent
    # subset LCBs in arbitrary order — downstream gap-region assembly
    # assumes chain order and would crop misordered anchors to nothing)
    keys = np.abs(ml.starts).astype(np.int64)
    keys[ml.starts == NO_MATCH] = np.iinfo(np.int64).max
    for lid in range(int(lcb_ids.max()) + 1):
        idx = np.nonzero(lcb_ids == lid)[0]
        sub_keys = keys[idx]
        idx = idx[
            np.lexsort(tuple(sub_keys[:, g] for g in range(n_seqs - 1, -1, -1)))
        ]
        sub = ml.select(idx)
        if match_weights is None:
            weight = int(sub.lengths.sum())
        else:
            weight = float(match_weights[idx].sum())
        lefts = np.zeros(n_seqs, np.int64)
        rights = np.zeros(n_seqs, np.int64)
        strands = np.zeros(n_seqs, np.int8)
        for g in range(n_seqs):
            comp = sub.starts[:, g]
            present = comp != NO_MATCH
            if not present.any():
                continue
            l = np.abs(comp[present])
            rr = l + sub.lengths[present] - 1
            lefts[g] = l.min()
            rights[g] = rr.max()
            strands[g] = np.sign(comp[present][0])
        out.append(LCB(idx, weight, lefts, rights, strands))
    return out


def greedy_breakpoint_elimination(
    ml: MatchList, min_weight: float, weight_fn=None
) -> Tuple[MatchList, List[LCB]]:
    """Drop minimum-weight LCBs until every LCB's weight meets min_weight
    (min_weight < 0 = collinear mode: eliminate to a single LCB).

    weight_fn: optional MatchList -> [n] float per-anchor weights (anchor
    scoring schemes, models/anchor_score.py); default = match lengths
    (the original Mauve weight, src/mauveAligner.cpp:648-656).  min_weight
    must be in the same units as the weights.

    Returns (surviving matches sorted along seq 0, final LCBs).

    Removal is cohort-batched: each round removes every LCB lighter than
    min(min_weight, 2*current_minimum).  This matches one-at-a-time greedy
    removal except when several same-cohort LCBs would have merged across a
    removal into an above-threshold block — a bounded deviation that turns
    hundreds of O(n log n) rounds into a handful.
    """
    cur = ml.sort_by_sequence(0)
    while True:
        if len(cur) == 0:
            return cur, []
        ids = compute_lcb_boundaries(cur)
        mw = weight_fn(cur) if weight_fn is not None else cur.lengths.astype(np.float64)
        weights = np.bincount(ids, weights=mw)
        n_lcbs = len(weights)
        if min_weight < 0:
            # collinear mode: strict one-at-a-time to a single survivor
            if n_lcbs <= 1:
                return cur, build_lcbs(cur, ids, mw if weight_fn is not None else None)
            victim = int(np.argmin(weights))
            cur = cur.select(ids != victim)
            continue
        wmin = weights.min()
        if wmin >= min_weight:
            return cur, build_lcbs(cur, ids, mw if weight_fn is not None else None)
        cutoff = min(float(min_weight), wmin * 2 + 1)
        drop_lcb = weights < cutoff
        if not drop_lcb.any():
            # custom weight_fn with wmin <= -1 makes wmin*2+1 < wmin; drop
            # the minimum cohort directly so the loop always progresses
            drop_lcb = weights <= wmin
        cur = cur.select(~drop_lcb[ids])


def lcb_list_summary(lcbs: List[LCB]) -> str:
    return f"{len(lcbs)} LCBs, weights {[l.weight for l in lcbs]}"
