"""Distance / identity matrices over alignments and match lists.

Equivalents of libMems DistanceMatrix.h: DistanceMatrix (match-coverage
based, used for guide trees at src/mauveAligner.cpp:617-618), IdentityMatrix
(src/mauveAligner.cpp:798-800) and BackboneIdentityMatrix
(src/pairCompare.cpp:60).
"""

from __future__ import annotations

from typing import List, Sequence, TextIO, Union

import numpy as np

from mauvealigner_tpu_torch.core.interval import IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.genome.sequence import Genome


def coverage_distance_matrix(ml: MatchList, seq_lengths: Sequence[int]) -> np.ndarray:
    """Pairwise distance = 1 - shared match coverage fraction
    (DistanceMatrix over a MatchList; guide-tree input).

    Coverage is the UNION of match extents (multi-MUM subsets overlap their
    n-way counterparts, so summing lengths would double-count)."""
    n = len(seq_lengths)
    shared = np.zeros((n, n), np.int64)
    # per-sequence sort orders are pair-independent; compute once
    abs_starts = np.abs(ml.starts)
    orders = [np.argsort(abs_starts[:, i], kind="stable") for i in range(n)]
    for i in range(n):
        oi = orders[i]
        lefts_all = abs_starts[oi, i]
        rights_all = lefts_all + ml.lengths[oi] - 1
        present_i = ml.starts[oi, i] != 0
        for j in range(n):
            if i == j:
                continue
            both = present_i & (ml.starts[oi, j] != 0)
            if not both.any():
                continue
            l = lefts_all[both]
            r = rights_all[both]
            # union length of sorted-by-left intervals: interval k adds the
            # part of [l_k, r_k] past the running right frontier cm_{k-1}
            cm = np.maximum.accumulate(r)
            prev = np.concatenate(([np.int64(-1)], cm[:-1]))
            shared[i, j] = int(
                np.maximum(r - np.maximum(l, prev + 1) + 1, 0).sum()
            )
    dist = np.ones((n, n))
    for i in range(n):
        dist[i, i] = 0.0
        for j in range(n):
            if i != j:
                # mean-length normalization: min() would hide content present
                # in the longer genome only
                denom = (seq_lengths[i] + seq_lengths[j]) / 2
                dist[i, j] = 1.0 - min(1.0, shared[i, j] / denom) if denom else 1.0
    return dist


def identity_matrix(ivs: IntervalList, genomes: Sequence[Genome]) -> np.ndarray:
    """Pairwise nucleotide identity over aligned columns
    (IdentityMatrix, src/mauveAligner.cpp:798-800): identical aligned
    positions / min(genome lengths)."""
    n = ivs.n_seqs
    ident = np.zeros((n, n), np.int64)
    for iv in ivs.intervals:
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        if len(present) < 2:
            continue
        texts = {}
        for s in present:
            t = np.frombuffer(iv.aligned_text(genomes, s).upper().encode(), np.uint8)
            texts[s] = t
        for ai in range(len(present)):
            for bi in range(ai + 1, len(present)):
                i, j = present[ai], present[bi]
                ti, tj = texts[i], texts[j]
                eq = (ti == tj) & (ti != ord("-"))
                ident[i, j] += int(eq.sum())
                ident[j, i] = ident[i, j]
    out = np.ones((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                denom = min(len(genomes[i]), len(genomes[j]))
                out[i, j] = ident[i, j] / denom if denom else 0.0
    return out


def backbone_identity_matrix(
    ivs: IntervalList, genomes: Sequence[Genome], segments
) -> np.ndarray:
    """Identity computed only over backbone column ranges
    (BackboneIdentityMatrix, src/pairCompare.cpp:60)."""
    n = ivs.n_seqs
    ident = np.zeros((n, n), np.int64)
    cols_used = np.zeros((n, n), np.int64)
    for seg in segments:
        iv = ivs.intervals[seg.interval_index]
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        texts = {
            s: np.frombuffer(iv.aligned_text(genomes, s).upper().encode(), np.uint8)[
                seg.col_start : seg.col_end
            ]
            for s in present
        }
        for ai in range(len(present)):
            for bi in range(ai + 1, len(present)):
                i, j = present[ai], present[bi]
                ti, tj = texts[i], texts[j]
                both = (ti != ord("-")) & (tj != ord("-"))
                eq = both & (ti == tj)
                ident[i, j] += int(eq.sum())
                ident[j, i] = ident[i, j]
                cols_used[i, j] += int(both.sum())
                cols_used[j, i] = cols_used[i, j]
    out = np.ones((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                out[i, j] = ident[i, j] / cols_used[i, j] if cols_used[i, j] else 0.0
    return out


def write_matrix(m: np.ndarray, out: Union[str, TextIO], labels: Sequence[str] = ()) -> None:
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_matrix(m, fh, labels)
            return
    fh = out
    if labels:
        fh.write("\t" + "\t".join(labels) + "\n")
    for i in range(m.shape[0]):
        row = "\t".join(f"{v:.6f}" for v in m[i])
        prefix = f"{labels[i]}\t" if labels else ""
        fh.write(prefix + row + "\n")
