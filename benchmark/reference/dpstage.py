"""The gapped closure's DP stage, judged problem by problem.

A progressive job aligns profiles of clades that exist only inside the
program, so its output alone cannot show whether each DP problem was solved
optimally.  The harness records, during the untimed warm job (which writes
the same bytes as every timed job), each problem the program hands its DP
launches: the two code strings or count profiles, their lengths and whether
rows are normalized, and the path the program returned.  Here the reference
works out each problem's optimal score anew (reference/gotoh.py in float64:
HOXD70 expected over the profile rows, open -400, extend -30) and scores the
program's path exactly; `dp_gap` is the widest shortfall of a path below the
optimum.  A path that does not consume both sequences exactly counts as an
infinite gap.  The score each launch returned beside its path is held to
the optimum too: `dp_score_gap` is the widest distance between them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gotoh

# ops of a returned path: 1 diagonal, 2 a base of A against a gap, 3 of B
_OP_KIND = np.array([-1, gotoh.DIAG, gotoh.A_ONLY, gotoh.B_ONLY], np.int8)


def _rows(p: np.ndarray, normalize: bool) -> np.ndarray:
    p = np.asarray(p, np.float64)
    if normalize:
        p = p / np.maximum(p.sum(-1, keepdims=True), 1)
    return p


def _path_scores(paths, la, lb, diag_score):
    """Exact score of each path (op arrays) and whether it consumes its two
    sequences exactly; diag_score(problem, i, j) scores diagonal cells."""
    L = np.array([len(p) for p in paths], np.int64)
    pid = np.repeat(np.arange(len(paths)), L)
    ops = np.concatenate(paths).astype(np.int64) if len(paths) else np.zeros(0, np.int64)
    kinds = _OP_KIND[np.clip(ops, 0, 3)]
    takes_a = kinds != gotoh.B_ONLY
    takes_b = kinds != gotoh.A_ONLY
    first = np.cumsum(L) - L
    ia = np.cumsum(takes_a) - 1
    ib = np.cumsum(takes_b) - 1
    ia -= np.repeat(np.concatenate([[0], np.cumsum(takes_a)])[first], L)
    ib -= np.repeat(np.concatenate([[0], np.cumsum(takes_b)])[first], L)
    ok = ((np.bincount(pid, weights=kinds < 0, minlength=len(paths)) == 0)
          & (np.bincount(pid, weights=takes_a, minlength=len(paths)) == la)
          & (np.bincount(pid, weights=takes_b, minlength=len(paths)) == lb))
    diag = kinds == gotoh.DIAG
    per = np.zeros(len(kinds))
    per[diag] = diag_score(pid[diag], ia[diag], ib[diag])
    gap = ~diag
    opens = gap & np.concatenate([[True], (kinds[1:] != kinds[:-1]) | (pid[1:] != pid[:-1])])
    per += gap * gotoh.GAP_EXTEND + opens * gotoh.GAP_OPEN
    return np.bincount(pid, weights=per, minlength=len(paths)), ok


def judge_calls(calls, device, dtype=torch.float64):
    """(path gaps per problem, returned-score gaps per problem, counts) over
    every recorded call."""
    gaps, score_gaps, bad_paths, problems, cells = [], [], 0, 0, 0
    for call in calls:
        la, lb = np.asarray(call["la"], np.int64), np.asarray(call["lb"], np.int64)
        live = np.flatnonzero((la > 0) & (lb > 0))
        if not len(live):
            continue
        problems += len(live)
        cells += int((la[live] * lb[live]).sum())
        side = np.maximum(la[live], lb[live])
        bucket = np.maximum(16, 2 ** np.ceil(np.log2(side))).astype(np.int64)
        for bk in np.unique(bucket):
            sel = live[bucket == bk]
            step = max(1, (1 << 22) // int(bk))
            for s in range(0, len(sel), step):
                part = sel[s:s + step]
                ma, nb = int(la[part].max()), int(lb[part].max())
                if call["kind"] == "codes":
                    A = np.minimum(np.asarray(call["a"][part, :ma], np.int64), 4)
                    B = np.minimum(np.asarray(call["b"][part, :nb], np.int64), 4)
                    fn = gotoh.code_array_scores(A, B, dtype, device)
                    score = lambda k, i, j: gotoh.HOXD70[A[k, i], B[k, j]]  # noqa: E731
                else:
                    A = _rows(call["a"][part, :ma], call["normalize"])
                    B = _rows(call["b"][part, :nb], call["normalize"])
                    fn = gotoh.profile_scores(A, B, False, dtype, device)
                    Q = A @ gotoh.HOXD70
                    score = lambda k, i, j: np.einsum("ij,ij->i", Q[k, i], B[k, j])  # noqa: E731
                best, _ = gotoh._forward(la[part], lb[part], fn, dtype, device, False)
                got, ok = _path_scores([np.asarray(call["ops"][p]) for p in part],
                                       la[part], lb[part], score)
                best = best.double().cpu().numpy()
                bad_paths += int((~ok).sum())
                gaps.append(np.where(ok, best - got, np.inf))
                score_gaps.append(np.abs(np.asarray(call["scores"])[part] - best))
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    score_gaps = np.concatenate(score_gaps) if score_gaps else np.zeros(0)
    return gaps, score_gaps, {"dp_problems": problems, "dp_cells": cells,
                              "dp_bad_paths": bad_paths}
