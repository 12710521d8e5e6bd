"""Iterative refinement of progressive alignments.

ProgressiveAligner::setRefinement equivalent (src/progressiveMauve.cpp:578-579):
after the initial guide-tree closure, alignment windows are re-aligned and a
replacement is kept only when the sum-of-pairs score improves.

Redesign for batching: every interval is split at clean columns (no gaps in
any present sequence — safe cut points), windows are re-aligned from their
ungapped sequences in one batched hierarchical closure pass, and each window
is accepted/rejected independently by SP score.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.models import closure


def _split_realign(
    jobs, groups, side_a, side_b, gap_open, gap_extend, subst=None, device="cuda"
):
    """Root-edge profile-profile re-alignment of every window: keep each
    side's internal alignment (all-gap columns dropped within the side),
    align the two count profiles with ONE batched DP, and stitch.  Returns
    (jobs, groups, new_alns, new_codes, rest_jobs, rest_groups) — windows
    with an empty side (every present sequence on one side of the root
    bipartition, e.g. subset LCBs) cannot be re-aligned this way and are
    handed back for the rebuild fallback."""
    from mauvealigner_tpu_torch.ops import dp

    GAP = np.int8(5)
    kept_jobs, kept_groups, sides = [], [], []
    rest_jobs, rest_groups = [], []
    pairs = []
    for job, regs in zip(jobs, groups):
        win = job[3]
        rows_a = [s for s in side_a if s < win.shape[0] and (win[s] != GAP).any()]
        rows_b = [s for s in side_b if s < win.shape[0] and (win[s] != GAP).any()]
        if not rows_a or not rows_b:
            rest_jobs.append(job)
            rest_groups.append(regs)
            continue
        cols_a = (win[rows_a] != GAP).any(axis=0)
        cols_b = (win[rows_b] != GAP).any(axis=0)
        cc_a = win[rows_a][:, cols_a]
        cc_b = win[rows_b][:, cols_b]
        kept_jobs.append(job)
        kept_groups.append(regs)
        sides.append((rows_a, rows_b, cc_a, cc_b))
        pairs.append((cc_a, cc_b))
    if not kept_jobs:
        return [], [], [], [], rest_jobs, rest_groups
    profs = closure._profiles_of_many([m for p in pairs for m in p])
    ops_all = dp.align_profile_pairs(
        list(zip(profs[::2], profs[1::2])), dp.HOXD70 if subst is None else subst,
        gap_open, gap_extend, device=device,
    )
    new_alns, new_codes_all = [], []
    for job, (rows_a, rows_b, cc_a, cc_b), ops in zip(kept_jobs, sides, ops_all):
        win = job[3]
        consumes_a, consumes_b = dp.ops_to_gap_rows(ops)
        new_codes = np.full((win.shape[0], len(ops)), GAP, np.int8)
        new_codes[np.ix_(rows_a, np.nonzero(consumes_a)[0])] = cc_a
        new_codes[np.ix_(rows_b, np.nonzero(consumes_b)[0])] = cc_b
        new_codes_all.append(new_codes)
        new_alns.append(new_codes != GAP)
    return kept_jobs, kept_groups, new_alns, new_codes_all, rest_jobs, rest_groups


def _codes_from_alns(jobs, new_alns, groups) -> List[np.ndarray]:
    """Reconstruct int8 column-code matrices from rebuild-path alignment
    masks (each row's bases fill its True cells in order)."""
    out = []
    for (k, a, b, win), new_aln, regs in zip(jobs, new_alns, groups):
        new_codes = np.full((win.shape[0], new_aln.shape[1]), 5, np.int8)
        for s in range(win.shape[0]):
            cols = np.nonzero(new_aln[s])[0]
            new_codes[s, cols] = regs[s][: len(cols)]
        out.append(new_codes)
    return out


def _window_bounds(iv: Interval, target: int) -> List[Tuple[int, int]]:
    """Split columns into windows of roughly `target` columns, cutting only
    at clean columns (every present sequence has a base)."""
    present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
    if not present or iv.n_cols == 0:
        return [(0, iv.n_cols)] if iv.n_cols else []
    clean = np.all(iv.aln[present], axis=0)
    bounds = [0]
    pos = 0
    while pos + target < iv.n_cols:
        cut_candidates = np.nonzero(clean[pos + target // 2 : pos + 2 * target])[0]
        if len(cut_candidates) == 0:
            pos = pos + 2 * target
            continue
        cut = pos + target // 2 + int(cut_candidates[np.argmin(np.abs(cut_candidates - target // 2))])
        if cut <= bounds[-1]:
            break
        bounds.append(cut)
        pos = cut
    if bounds[-1] != iv.n_cols:
        bounds.append(iv.n_cols)
    return list(zip(bounds[:-1], bounds[1:]))


def _plan_bipartition(plan, n_seqs: int) -> Tuple[List[int], List[int]]:
    """Leaf sets on the two sides of the merge plan's FINAL (root) merge —
    the deepest divergence, where progressive closure leaves the most
    misalignment."""
    members: dict = {}

    def of(x):
        return {x} if isinstance(x, (int, np.integer)) else members[x]

    if not plan:
        plan = closure.chain_plan(n_seqs)
    for node, left, right in plan:
        members[node] = of(left) | of(right)
    _, left, right = plan[-1]
    return sorted(of(left)), sorted(of(right))


def refine_intervals(
    ivl: IntervalList,
    plan=None,
    window: int = 256,
    rounds: int = 1,
    gap_open: float = -400.0,
    gap_extend: float = -30.0,
    mode: str = "split",
    subst=None,
    device="cuda",
) -> Tuple[IntervalList, int]:
    """Window-polish every multi-sequence interval; returns (refined list,
    number of windows improved).  The re-alignment DP runs on `device`.

    mode="split" (default): each window keeps the two root-side groups'
    internal alignments and re-aligns their count profiles against each
    other — ONE profile DP per window.  mode="rebuild": re-align the
    window from its ungapped sequences along the whole merge plan
    (n_seqs - 1 DPs per window; the original formulation).  Both accept a
    replacement only when the window's sum-of-pairs score improves, so
    quality is monotone under either mode."""
    from mauvealigner_tpu_torch.utils import timing

    genomes = ivl.genomes
    improved_total = 0
    intervals = list(ivl.intervals)
    GAP = np.int8(5)
    side_a, side_b = (None, None)
    for _ in range(rounds):
        jobs: List[Tuple[int, int, int, np.ndarray]] = []  # (iv idx, a, b, col_codes)
        groups: List[List[np.ndarray]] = []
        from mauvealigner_tpu_torch.analysis.sp import interval_column_codes

        with timing.GLOBAL.phase("rf_windows"):
            for k, iv in enumerate(intervals):
                if iv.multiplicity() < 2 or iv.n_cols == 0:
                    continue
                if side_a is None:
                    side_a, side_b = _plan_bipartition(plan, iv.n_seqs)
                codes = interval_column_codes(iv, genomes)
                for a, b in _window_bounds(iv, window):
                    win = codes[:, a:b]
                    regs = []
                    for s in range(iv.n_seqs):
                        row = win[s]
                        regs.append(row[row < 5])  # int8 codes <= 4
                    if sum(1 for r in regs if len(r)) < 2:
                        continue
                    jobs.append((k, a, b, win))
                    groups.append(regs)
        if not jobs:
            break
        kw = {} if subst is None else {"subst": subst}
        with timing.GLOBAL.phase("rf_closure"):
            if mode == "split":
                jobs, groups, new_alns, new_codes_all, rest_jobs, rest_groups = (
                    _split_realign(
                        jobs, groups, side_a, side_b, gap_open, gap_extend, subst,
                        device,
                    )
                )
                if rest_jobs:
                    # one-sided windows (e.g. subset LCBs entirely within one
                    # root clade) fall back to the full rebuild re-alignment —
                    # dropping them would leave those intervals unpolished
                    rest_alns = closure.hierarchical_align_region_groups(
                        rest_groups, plan, gap_open=gap_open, gap_extend=gap_extend,
                        device=device, **kw,
                    )
                    jobs = jobs + rest_jobs
                    groups = groups + rest_groups
                    new_alns = new_alns + rest_alns
                    new_codes_all = new_codes_all + _codes_from_alns(
                        rest_jobs, rest_alns, rest_groups
                    )
            else:
                new_alns = closure.hierarchical_align_region_groups(
                    groups, plan, gap_open=gap_open, gap_extend=gap_extend,
                    device=device, **kw,
                )
        if not jobs:
            break
        # evaluate and apply per interval; old/new windows score in one
        # grouped batch (per-window calls were refinement's host hotspot)
        from mauvealigner_tpu_torch.analysis.sp import match_and_gap_scores_batch

        with timing.GLOBAL.phase("rf_score"):
            if mode != "split":
                new_codes_all = _codes_from_alns(jobs, new_alns, groups)
            mats = [j[3] for j in jobs] + new_codes_all
            m_all, g_all = match_and_gap_scores_batch(
                mats, gap_open=gap_open, gap_extend=gap_extend
            )
            scores = m_all + g_all
        with timing.GLOBAL.phase("rf_apply"):
            n_jobs = len(jobs)
            by_iv: dict = {}
            for j, ((k, a, b, win), new_aln) in enumerate(zip(jobs, new_alns)):
                if scores[n_jobs + j] > scores[j]:
                    by_iv.setdefault(k, []).append((a, b, new_aln))
            improved_total += sum(len(v) for v in by_iv.values())
            for k, repls in by_iv.items():
                iv = intervals[k]
                repls.sort()
                pieces = []
                pos = 0
                for a, b, new_aln in repls:
                    if a > pos:
                        pieces.append(iv.aln[:, pos:a])
                    pieces.append(new_aln)
                    pos = b
                if pos < iv.n_cols:
                    pieces.append(iv.aln[:, pos:])
                intervals[k] = Interval(iv.starts.copy(), np.concatenate(pieces, axis=1))
    return (
        IntervalList(
            genomes=genomes, intervals=intervals, seq_filenames=list(ivl.seq_filenames)
        ),
        improved_total,
    )
