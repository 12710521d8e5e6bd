"""Anchor scoring schemes for progressive LCB determination.

Reproduces the intent of libMems' ProgressiveAligner scoring schemes
(AncestralScoring / AncestralSumOfPairsScoring / ExtantSumOfPairsScoring,
selected at src/progressiveMauve.cpp:611-625; default "sp" = extant
sum-of-pairs) together with pairwise LCB-weight scaling
(setUseLcbWeightScaling + setBreakpointDistanceScale /
setConservationDistanceScale defaults 0.5/0.5, src/progressiveMauve.cpp:626-637).
libMems' implementation is not in the snapshot, so the formulas here are
re-derived from the documented semantics rather than transcribed.

Key simplification that makes this exact AND cheap: anchors are multi-MUMs,
i.e. every present component is the SAME substring (up to reverse
complement).  The HOXD70 substitution matrix's diagonal is
complement-invariant (A<->T: 91, C<->G: 100), so the pairwise score of an
anchor column is diag(c) for the shared base c regardless of orientation,
and the extant sum-of-pairs score of an anchor is

    sp(m) = [sum over pairs (i<j) present: scale_ij] * D(m)

with D(m) the diagonal-score sum over the anchor span, computed in O(1) per
anchor from a per-genome prefix sum.  The "ancestral" schemes score extant
rows against the inferred ancestor, which for an exact-match anchor is the
same substring, leaving only the combinatorial factor:

    ancestral:    n_present            (each row vs the ancestor)
    sp_ancestral: n_present - 1        (ancestor path edges)
    sp (default): C(n_present, 2)      (all extant pairs)

Distance-based LCB weight scaling multiplies each pair's contribution by
scale_ij = max(floor, 1 - bp_scale*d_ij) * max(floor, 1 - cons_scale*d_ij)
where d_ij is the pairwise coverage distance (the same estimate that feeds
the guide tree) — distant pairs contribute less weight, so chance anchors
between diverged genomes don't outvote the breakpoint penalty.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.ops.dp import HOXD70

# diag(A,C,G,T) plus ambiguity self-score; complement-invariant by
# construction of HOXD70 (see module docstring)
_DIAG = np.array([HOXD70[i, i] for i in range(5)], dtype=np.float64)

SCALE_FLOOR = 0.2  # setMinimumBreakpointPenalty analog: never scale below this


def diag_prefix(genome: Genome) -> np.ndarray:
    """Prefix sums P of the HOXD diagonal over the genome's codes:
    P[k] = sum of diag(code[0..k-1]); cached on the genome object."""
    cached = getattr(genome, "_diag_prefix", None)
    if cached is not None:
        return cached
    codes = np.minimum(genome.codes, 4)
    pref = np.concatenate([[0.0], np.cumsum(_DIAG[codes])])
    genome._diag_prefix = pref
    return pref


def pair_scales(
    dist: np.ndarray,
    breakpoint_scale: float = 0.5,
    conservation_scale: float = 0.5,
) -> np.ndarray:
    """Per-pair weight scale factors from a pairwise distance matrix."""
    bp = np.maximum(SCALE_FLOOR, 1.0 - breakpoint_scale * dist)
    cons = np.maximum(SCALE_FLOOR, 1.0 - conservation_scale * dist)
    out = bp * cons
    np.fill_diagonal(out, 0.0)
    return out


def expected_diag(genomes: Sequence[Genome]) -> float:
    """Expected diagonal score per column given the genomes' GC content —
    the unit conversion between length-weights and sp-weights."""
    total = sum(len(g) for g in genomes)
    if total == 0:
        return float(_DIAG[:4].mean())
    gc = sum(float(np.sum((g.codes == 1) | (g.codes == 2))) for g in genomes) / total
    return float((1.0 - gc) * 91.0 + gc * 100.0)


def anchor_weights(
    genomes: Sequence[Genome],
    ml: MatchList,
    scheme: str = "sp",
    scales: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-anchor weights [n_matches] float64 under the given scheme.

    scales: optional [n_seqs, n_seqs] pairwise factors (pair_scales output);
    only used by the "sp" scheme.
    """
    n = len(ml)
    if n == 0:
        return np.zeros(0, np.float64)
    present = ml.starts != NO_MATCH  # [n, n_seqs]
    # diagonal-score sum over the span, via the first present component
    first = np.argmax(present, axis=1)
    starts = np.abs(ml.starts[np.arange(n), first])
    lens = ml.lengths.astype(np.int64)
    D = np.zeros(n, np.float64)
    for g in range(ml.n_seqs):
        sel = first == g
        if not sel.any():
            continue
        pref = diag_prefix(genomes[g])
        s = starts[sel]
        l = lens[sel]
        # reverse-strand starts index the forward strand (|start| = leftmost
        # forward coordinate), so the span is always [s-1, s-1+l)
        D[sel] = pref[s - 1 + l] - pref[s - 1]
    k = present.sum(axis=1).astype(np.float64)
    if scheme == "ancestral":
        factor = k
    elif scheme == "sp_ancestral":
        factor = np.maximum(k - 1.0, 0.0)
    elif scheme == "sp":
        if scales is None:
            factor = k * (k - 1.0) / 2.0
        else:
            pf = present.astype(np.float64)
            # sum over present pairs of scale_ij = (p^T S p - trace terms)/2
            factor = 0.5 * np.einsum("ni,ij,nj->n", pf, scales, pf)
    else:
        raise ValueError(f"unknown scoring scheme {scheme!r}")
    return factor * D


def make_weight_fn(
    genomes: Sequence[Genome],
    scheme: str = "sp",
    scales: Optional[np.ndarray] = None,
):
    """Weight callback for greedy_breakpoint_elimination: recomputed after
    every crop/selection so weights always reflect current anchor spans."""

    def fn(ml: MatchList) -> np.ndarray:
        return anchor_weights(genomes, ml, scheme, scales)

    return fn
