"""The judgement of a two-genome mauveAligner job: its XMFA, its anchors
(.mln) and the gapped closure between them, against the inputs.

- The XMFA must hold the genomes: every row's bases are the genome interval
  its header names, no base sits in two rows, and a block's rows are of one
  length (xmfa.validity).
- The gapped closure must be optimal.  Columns where the XMFA pairs two
  positions that one of the anchors in the .mln pairs are cut points;
  between two cut points lies a piece of one gapped region, which the
  program aligns globally with affine gaps (HOXD70, open -400, extend -30).
  A piece of an optimal alignment cut at aligned columns is itself optimal,
  so for each piece the reference's optimal score (gotoh.best_scores, in
  float32, exact for these integer scores) must equal the score of the
  program's columns.  `closure_gap` is the widest shortfall.  Pieces with a
  side over max_gapped_len (4096) are left unaligned by the program's
  stated semantics and are counted, not scored.
- Every DP problem the program handed its launches must come back solved:
  its path optimal (`dp_gap`) and the score returned beside it the optimum
  (`dp_score_gap`; reference/dpstage.py, in float64).  These integer sums
  are exact in float32 and not in bfloat16, which holds them to 8 bits.
- The anchor search must be the full one (`anchor_miss`, mln.py).
- The accuracy against the simulation truth (sensitivity and PPV of the
  aligned pairs) is reported for the end-to-end metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dpstage, gotoh, mln, xmfa

MAX_GAPPED_LEN = 4096


def pieces(aln: xmfa.Alignment, matches, len1: int):
    """Over the alignment's columns: the column kinds (gotoh.DIAG /
    A_ONLY / B_ONLY), each row's text, and the piece number of every
    column between anchors (-1 on an anchor column and outside blocks that
    hold both genomes).  A piece never spans two blocks."""
    r0, r1 = aln.rows_of(0), aln.rows_of(1)
    pa, pb = r0.pos, r1.pos
    both = (pa != 0) & (pb != 0)
    sign = np.where(np.sign(pa) == np.sign(pb), 1, -1)
    anchor = both & np.isin(mln.pair_key(np.abs(pa), sign * np.abs(pb), len1),
                            mln.anchor_pair_keys(matches, len1))
    kinds = np.where(both, gotoh.DIAG, np.where(pa != 0, gotoh.A_ONLY, gotoh.B_ONLY))
    inside = (r0.text != xmfa.NO_ROW) & (r1.text != xmfa.NO_ROW) & ((pa != 0) | (pb != 0))
    inside &= ~anchor
    first = np.zeros(aln.n_cols, bool)
    first[aln.block_start[:-1][aln.block_start[:-1] < aln.n_cols]] = True
    start = inside & (first | ~np.concatenate([[False], inside[:-1]]))
    piece = np.where(inside, np.cumsum(start) - 1, -1)
    return kinds, r0.text, r1.text, piece, int(start.sum())


def closure(aln: xmfa.Alignment, matches, len1: int, device):
    """Per piece that the program aligned by DP: the reference's optimal
    score and the score of the program's columns.  Returns (best, program,
    counts)."""
    kinds, ta, tb, piece, n = pieces(aln, matches, len1)
    on = piece >= 0
    kinds, ta, tb, piece = kinds[on], ta[on], tb[on], piece[on]
    la = np.bincount(piece, weights=kinds != gotoh.B_ONLY, minlength=n).astype(np.int64)
    lb = np.bincount(piece, weights=kinds != gotoh.A_ONLY, minlength=n).astype(np.int64)
    dp = (la > 0) & (lb > 0) & (la <= MAX_GAPPED_LEN) & (lb <= MAX_GAPPED_LEN)
    counts = {"pieces": n, "dp_pieces": int(dp.sum()),
              "unaligned_pieces": int(((la > MAX_GAPPED_LEN) | (lb > MAX_GAPPED_LEN)).sum()),
              "dp_cells": int((la[dp] * lb[dp]).sum())}
    ids = np.flatnonzero(dp)
    if not len(ids):
        return np.zeros(0), np.zeros(0), counts
    prog = gotoh.path_scores(kinds, gotoh.codes(ta), gotoh.codes(tb), piece, n)[ids]
    bounds = np.searchsorted(piece, np.arange(n + 1))  # piece is non-decreasing
    a_seqs = [ta[bounds[p]:bounds[p + 1]][ta[bounds[p]:bounds[p + 1]] != xmfa.GAP] for p in ids]
    b_seqs = [tb[bounds[p]:bounds[p + 1]][tb[bounds[p]:bounds[p + 1]] != xmfa.GAP] for p in ids]
    best = np.zeros(len(ids))
    side = np.maximum(la[ids], lb[ids])
    bucket = np.maximum(16, 2 ** np.ceil(np.log2(side))).astype(np.int64)
    for bk in np.unique(bucket):
        sel = np.flatnonzero(bucket == bk)
        step = max(1, (1 << 22) // int(bk))
        for s in range(0, len(sel), step):
            part = sel[s:s + step]
            best[part] = gotoh.best_scores([a_seqs[i] for i in part], [b_seqs[i] for i in part],
                                           torch.float32, device)
    return best, prog, counts


def judge(inputs, outputs, captured, device):
    """(numbers that decide `correct`, report)."""
    aln = xmfa.read_xmfa(outputs["xmfa"])
    valid = xmfa.validity(aln, inputs.genomes)
    matches = mln.read_matches(outputs["mln"])
    len1 = len(inputs.genomes[1])
    best, prog, counts = closure(aln, matches, len1, device)
    gap = best - prog
    dp_gaps, score_gaps, dp_counts = dpstage.judge_calls(captured.get("dp", []), device)
    amap = xmfa.pair_map(aln.rows_of(0), aln.rows_of(1), len(inputs.genomes[0]))
    sn, ppv, tally = xmfa.accuracy([amap], inputs.truths)
    numbers = {
        "bad_rows": valid["bad_rows"],
        "ragged_blocks": valid["ragged_blocks"],
        "bases_twice": valid["bases_twice"],
        "closure_gap": float(gap.max()) if len(gap) else 0.0,
        "dp_gap": float(dp_gaps.max()) if len(dp_gaps) else 0.0,
        "dp_score_gap": float(score_gaps.max()) if len(score_gaps) else 0.0,
        "anchor_miss": mln.unanchored_share(matches, inputs.truths[0], len1),
    }
    report = {**counts, **tally, **{f"launched_{k}": v for k, v in dp_counts.items()}, "aligned_sn": sn, "aligned_ppv": ppv,
              "closure_gap_min": float(gap.min()) if len(gap) else 0.0,
              "pieces_short": int(np.sum(gap > 0)), "blocks": aln.n_blocks,
              "matches": int(len(matches)), "bases_unaligned": valid["bases_unaligned"]}
    return numbers, report
