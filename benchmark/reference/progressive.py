"""The judgement of a progressiveMauve job: its XMFA, its backbone and its
accuracy, against the inputs and the simulation truths.

- The XMFA must hold the genomes, every base of every genome in exactly one
  block (xmfa.validity: bad rows, ragged blocks, bases twice, bases never).
- Every backbone row names, per genome, an interval inside the genome or
  none (0 0), at least one genome present.
- The backbone holds what is homologous in all the genomes: a position of
  genome 0 that the truths carry into every other genome must lie in a
  backbone row present in all of them whose interval in each genome holds
  the position's homolog there.  `backbone_miss` is the share that does not.
- Every DP problem of the gapped closure, refinement and the ladder is
  solved optimally (reference/dpstage.py: `dp_gap`).
- Every column of the homology HMM's decode gets the bit the reference's
  float64 decode gives it (reference/hmm.py: `hmm_flips`).
- The aligned position pairs of every (genome 0, genome i) projection are
  scored against the truths for the end-to-end metrics.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import dpstage, hmm, xmfa


def read_backbone(path: str) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().split("\n")[1:]
    rows = [l.split() for l in lines if l.strip()]
    return np.array(rows, np.int64).reshape(len(rows), -1)


def backbone_bad_rows(bb: np.ndarray, lengths) -> int:
    n = len(lengths)
    if bb.shape[1] != 2 * n:
        return len(bb) or 1
    left, right = np.abs(bb[:, 0::2]), np.abs(bb[:, 1::2])
    absent = (left == 0) & (right == 0)
    inside = (left >= 1) & (left <= right) & (right <= np.asarray(lengths)[None, :])
    return int(np.sum(~(absent | inside).all(axis=1) | absent.all(axis=1)))


def backbone_miss(bb: np.ndarray, truths) -> float:
    """Share of the positions of genome 0 homologous in every genome that
    no backbone row present in every genome holds, in genome 0 and at the
    homolog in each other genome."""
    core = np.flatnonzero(np.all([t[1:] != 0 for t in truths], axis=0)) + 1
    if not len(core):
        return 0.0
    if bb.shape[1] != 2 * (len(truths) + 1):
        return 1.0
    ends = np.abs(bb.reshape(len(bb), -1, 2))
    lo, hi = ends.min(axis=2), ends.max(axis=2)
    full = (lo > 0).all(axis=1)
    if not full.any():
        return 1.0
    order = np.argsort(lo[full, 0], kind="stable")
    lo, hi = lo[full][order], hi[full][order]
    row = np.searchsorted(lo[:, 0], core, side="right") - 1
    r = np.maximum(row, 0)
    held = (row >= 0) & (core <= hi[r, 0])
    for i, t in enumerate(truths, start=1):
        at = np.abs(t[core])
        held &= (lo[r, i] <= at) & (at <= hi[r, i])
    return 1.0 - float(held.mean())


def judge(inputs, outputs, captured, device):
    aln = xmfa.read_xmfa(outputs["xmfa"])
    valid = xmfa.validity(aln, inputs.genomes)
    lengths = [len(g) for g in inputs.genomes]
    bb = read_backbone(outputs["backbone"])
    r0 = aln.rows_of(0)
    maps = [xmfa.pair_map(r0, aln.rows_of(i), lengths[0]) for i in range(1, len(lengths))]
    sn, ppv, tally = xmfa.accuracy(maps, inputs.truths)
    per_pair = [xmfa.accuracy([m], [t])[:2] for m, t in zip(maps, inputs.truths)]
    gaps, score_gaps, dp_counts = dpstage.judge_calls(captured.get("dp", []), device)
    flips, hmm_counts = hmm.judge_calls(captured.get("hmm", []), inputs.genomes, device)
    numbers = {
        "bad_rows": valid["bad_rows"],
        "ragged_blocks": valid["ragged_blocks"],
        "bases_twice": valid["bases_twice"],
        "bases_unaligned": valid["bases_unaligned"],
        "backbone_bad_rows": backbone_bad_rows(bb, lengths),
        "backbone_miss": backbone_miss(bb, inputs.truths),
        "dp_gap": float(gaps.max()) if len(gaps) else 0.0,
        "hmm_flips": flips,
    }
    report = {**tally, **dp_counts, **hmm_counts,
              "dp_score_gap": float(score_gaps.max()) if len(score_gaps) else 0.0, "dp_gap_min": float(gaps.min()) if len(gaps) else 0.0,
              "dp_short": int(np.sum(gaps > 1e-6)), "blocks": aln.n_blocks, "aligned_sn": sn, "aligned_ppv": ppv,
              "backbone_rows": int(len(bb)),
              "pair_sn_ppv": [[round(a, 6), round(b, 6)] for a, b in per_pair]}
    return numbers, report
