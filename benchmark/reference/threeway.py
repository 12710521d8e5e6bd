"""The judgement of a three-genome mauveAligner job: its XMFA, its anchors
(.mln), the star-progressive closure between them and every DP problem it
launched, against the inputs.

- The XMFA must hold the genomes: every row's bases are the genome interval
  its header names, no base sits in two rows, and a block's rows are of one
  length (xmfa.validity, over all three rows).
- The closure of three genomes follows the chain plan ((0 + 1) + 2): its
  first merge aligns each gap region of genome 0 with genome 1's, code
  pair against code pair, and its second merge adds genome 2 by inserting
  columns in which rows 0 and 1 are both gaps.  So the (genome 0, genome
  1) projection of the XMFA, those columns taken out, is the first merge's
  alignment, and each of its pieces between anchors must be optimal, as in
  the two-genome check (pairwise.closure): `closure_gap`.  The program
  leaves a region group unaligned where a region, or a merge's width,
  passes max_gapped_len (4096): such a group shows as a piece with no
  aligned column whose sides sum past 4096 or whose genome 2 bases pass
  it, and is counted, not scored.
- Every DP problem the program handed its launches, code pairs and count
  profiles alike, must come back solved: its path optimal (`dp_gap`) and
  its returned score the optimum (`dp_score_gap`; reference/dpstage.py, in
  float64).  The closure's profiles are unnormalized counts, so every
  score is an integer sum, exact in float32 and not in bfloat16.
- Every three-genome anchor of the .mln must lie in the XMFA as it claims,
  each of its bases in one column with the homologs it names
  (`anchors_unaligned`): a row left out, or a row shifted, leaves anchors
  out of the alignment.
- The anchor search must be the full one: `anchor_miss` is the share of
  the positions of genome 0 that the truths carry into both other genomes
  whose homologs in both no three-genome anchor of the .mln claims.
- The accuracy against the simulation truth is pooled over the (genome 0,
  genome 1) and (genome 0, genome 2) projections for the end-to-end
  metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference import dpstage, gotoh, mln, pairwise, xmfa


@dataclasses.dataclass
class Projection:
    """Rows 0 and 1 of an alignment without the columns where both are
    gaps: what pairwise.pieces reads of an Alignment."""

    rows: tuple
    n_cols: int
    block_start: np.ndarray

    def rows_of(self, s: int) -> xmfa.Rows:
        return self.rows[s]


def project(aln: xmfa.Alignment, a: int = 0, b: int = 1):
    """(the projection, and for every column of `aln` the projection's
    column at or before it in the same block, -1 where none)."""
    ra, rb = aln.rows_of(a), aln.rows_of(b)
    keep = ~((ra.text == xmfa.GAP) & (rb.text == xmfa.GAP))
    kept = np.concatenate([[0], np.cumsum(keep)])
    new_start = kept[aln.block_start].astype(np.int64)
    cut = [xmfa.Rows(r.text[keep], r.pos[keep], r.row[keep]) for r in (ra, rb)]
    at = kept[1:] - 1
    block = np.searchsorted(aln.block_start, np.arange(aln.n_cols), side="right") - 1
    at[at < new_start[block]] = -1
    return Projection(tuple(cut), int(keep.sum()), new_start), at


def closure_gaps(aln: xmfa.Alignment, matches, len1: int, device):
    """(shortfall of each scored piece of the (0, 1) projection, counts)."""
    proj, at = project(aln)
    kinds, _, _, piece, n = pairwise.pieces(proj, matches, len1)
    # genome 2's bases of each piece: those in columns whose nearest
    # projected column at or before them, in their block, is the piece's
    c_piece = np.append(piece, -1)[at]
    lc = np.bincount(c_piece[(aln.rows_of(2).pos != 0) & (c_piece >= 0)], minlength=n)
    on = piece >= 0
    la = np.bincount(piece[on], weights=kinds[on] != gotoh.B_ONLY, minlength=n)
    lb = np.bincount(piece[on], weights=kinds[on] != gotoh.A_ONLY, minlength=n)
    diag = np.bincount(piece[on], weights=kinds[on] == gotoh.DIAG, minlength=n)
    big = pairwise.MAX_GAPPED_LEN
    left_out = (diag == 0) & ((la + lb > big) | (lc > big))
    # such pieces leave the projection (their columns marked as holding no
    # row of genome 1), so pairwise.closure neither finds nor scores them
    proj.rows[1].text[on & left_out[np.maximum(piece, 0)]] = xmfa.NO_ROW
    best, prog, counts = pairwise.closure(proj, matches, len1, device)
    counts["width_unaligned_pieces"] = int(left_out.sum())
    return best - prog, counts


def anchor_claims(matches: np.ndarray):
    """[bases, 3]: for every base of every anchor present in all three
    genomes, its genome 0 position and the signed positions it claims in
    genomes 1 and 2, as mln.anchor_pair_keys reads a match: genome 0's
    offsets run forward, and a genome on the other strand than genome 0's
    pairs them from its last base.  Also the anchor of each base."""
    m = matches[(matches[:, 1:] != 0).all(axis=1)]
    lengths = m[:, 0]
    idx = np.repeat(np.arange(len(m)), lengths)
    off = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    L = lengths[idx]
    rows = [np.abs(m[idx, 1]) + off]
    for g in (2, 3):
        s = m[idx, g]
        same = np.sign(s) == np.sign(m[idx, 1])
        rows.append(np.where(same, np.abs(s) + off, -(np.abs(s) + L - 1 - off)))
    return np.stack(rows, axis=1), idx


def anchored_share_missing(claims: np.ndarray, truths) -> float:
    """Share of genome 0's positions homologous in both other genomes (by
    the truths) whose homologs in both no anchor claims."""
    t1, t2 = truths
    core = np.flatnonzero((t1[1:] != 0) & (t2[1:] != 0)) + 1
    if not len(core):
        return 0.0
    want = np.stack([core, t1[core], t2[core]], axis=1)
    return float(1.0 - np.isin(_row_keys(want), _row_keys(claims)).mean())


def anchors_unaligned(claims: np.ndarray, idx: np.ndarray, maps) -> int:
    """Anchors of the .mln some base of which the XMFA does not put in one
    column with the homologs the anchor claims (maps: xmfa.pair_map of
    genome 0 with genomes 1 and 2)."""
    p0 = claims[:, 0]
    inside = (p0 >= 1) & (p0 < len(maps[0]))
    at = np.where(inside, p0, 0)
    held = inside & (maps[0][at] == claims[:, 1]) & (maps[1][at] == claims[:, 2])
    return int(len(np.unique(idx[~held])))


def _row_keys(a: np.ndarray) -> np.ndarray:
    """One comparable value per row of an int64 [k, 3] array."""
    a = np.ascontiguousarray(a, np.int64)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()


def judge(inputs, outputs, captured, device):
    """(numbers that decide `correct`, report)."""
    aln = xmfa.read_xmfa(outputs["xmfa"])
    valid = xmfa.validity(aln, inputs.genomes)
    matches = mln.read_matches(outputs["mln"])
    len1 = len(inputs.genomes[1])
    gap, counts = closure_gaps(aln, matches, len1, device)
    calls = captured.get("dp", [])
    dp_gaps, score_gaps, dp_counts, by_kind = [], [], {}, {}
    for kind in ("codes", "profiles"):
        g, sg, c = dpstage.judge_calls([x for x in calls if x["kind"] == kind], device)
        dp_gaps.append(g)
        score_gaps.append(sg)
        for k, v in c.items():
            dp_counts[k] = dp_counts.get(k, 0) + v
        by_kind[f"{kind}_dp_problems"] = c["dp_problems"]
        by_kind[f"{kind}_dp_gap"] = float(g.max()) if len(g) else 0.0
        by_kind[f"{kind}_dp_score_gap"] = float(sg.max()) if len(sg) else 0.0
    dp_gaps, score_gaps = np.concatenate(dp_gaps), np.concatenate(score_gaps)
    r0 = aln.rows_of(0)
    maps = [xmfa.pair_map(r0, aln.rows_of(i), len(inputs.genomes[0])) for i in (1, 2)]
    claims, anchor_of = anchor_claims(matches)
    sn, ppv, tally = xmfa.accuracy(maps, inputs.truths)
    numbers = {
        "bad_rows": valid["bad_rows"],
        "ragged_blocks": valid["ragged_blocks"],
        "bases_twice": valid["bases_twice"],
        "closure_gap": float(gap.max()) if len(gap) else 0.0,
        "dp_gap": float(dp_gaps.max()) if len(dp_gaps) else 0.0,
        "dp_score_gap": float(score_gaps.max()) if len(score_gaps) else 0.0,
        "anchors_unaligned": anchors_unaligned(claims, anchor_of, maps),
        "anchor_miss": anchored_share_missing(claims, inputs.truths),
    }
    report = {**counts, **tally, **by_kind, **{f"launched_{k}": v for k, v in dp_counts.items()},
              "aligned_sn": sn, "aligned_ppv": ppv,
              "closure_gap_min": float(gap.min()) if len(gap) else 0.0,
              "pieces_short": int(np.sum(gap > 0)), "blocks": aln.n_blocks,
              "matches": int(len(matches)), "bases_unaligned": valid["bases_unaligned"]}
    return numbers, report
