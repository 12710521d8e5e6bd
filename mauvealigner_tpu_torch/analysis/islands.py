"""Island and simple-backbone detection (L6a).

Equivalents of libMems Islands.h: simpleFindIslands, findIslandsBetweenLCBs,
simpleFindBackbone (reference call sites src/mauveAligner.cpp:809-850,
src/pairCompare.cpp:42).

An *island* is a region inside an LCB where one sequence has a run of
unaligned (gap-opposed) characters longer than a threshold — candidate
horizontally-transferred / strain-specific sequence.  *Backbone* is the
complement: column ranges where every sequence is present for at least
min_bb_length with gaps shorter than max_gap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList


@dataclasses.dataclass
class Island:
    seq_i: int
    seq_j: int
    left_i: int
    right_i: int
    left_j: int
    right_j: int


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal runs of True: list of (start, end) half-open column indices."""
    if mask.size == 0:
        return []
    d = np.diff(np.concatenate([[0], mask.view(np.int8), [0]]))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return list(zip(starts.tolist(), ends.tolist()))


def _col_pos(iv: Interval, seq: int) -> np.ndarray:
    """Signed position per column (0 at gaps) — see score_alignment."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    return _interval_positions(iv, seq)


def simple_find_islands(
    ivs: IntervalList, island_size: int
) -> List[Island]:
    """Per sequence pair: runs of >= island_size columns where one sequence
    is gapped and the other is not (simpleFindIslands semantics)."""
    out: List[Island] = []
    for iv in ivs.intervals:
        if iv.multiplicity() < 2:
            continue
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        pos = {s: _col_pos(iv, s) for s in present}
        for ai in range(len(present)):
            for bi in range(ai + 1, len(present)):
                i, j = present[ai], present[bi]
                # project out both-gap columns: an island of one sequence
                # against the other continues across columns a THIRD
                # sequence inserted (the reference scans the pairwise
                # projection)
                keep_idx = np.nonzero(iv.aln[i] | iv.aln[j])[0]
                for gapped, other in ((i, j), (j, i)):
                    mask = (~iv.aln[gapped][keep_idx]) & iv.aln[other][keep_idx]
                    for sp_, ep_ in _runs(mask):
                        if ep_ - sp_ < island_size:
                            continue
                        s, e = int(keep_idx[sp_]), int(keep_idx[ep_ - 1]) + 1
                        # island bounds in both sequences (nearest bases)
                        pj = np.abs(pos[other][s:e])
                        pj = pj[pj > 0]
                        pi_all = np.abs(pos[gapped])
                        left_bases = pi_all[:s][pi_all[:s] > 0]
                        right_bases = pi_all[e:][pi_all[e:] > 0]
                        li = int(left_bases[-1]) if len(left_bases) else 0
                        ri = int(right_bases[0]) if len(right_bases) else 0
                        if gapped == i:
                            out.append(
                                Island(i, j, li, ri, int(pj.min()), int(pj.max()))
                            )
                        else:
                            out.append(
                                Island(j, i, li, ri, int(pj.min()), int(pj.max()))
                            )
    return out


def find_islands_between_lcbs(
    ivs: IntervalList, seq_lengths: Sequence[int], island_size: int
) -> List[Tuple[int, int, int]]:
    """Unaligned inter-LCB regions >= island_size: (seq, left, right)
    (findIslandsBetweenLCBs semantics, src/mauveAligner.cpp:845)."""
    out = []
    n = ivs.n_seqs
    for seq in range(n):
        glen = seq_lengths[seq]
        cov = np.zeros(glen + 2, np.int64)
        for iv in ivs.intervals:
            if iv.multiplicity() >= 2 and iv.starts[seq] != 0:
                l = int(abs(iv.starts[seq]))
                r = l + int(iv.aln[seq].sum()) - 1
                cov[l] += 1
                cov[r + 1] -= 1
        c = np.cumsum(cov[: glen + 1])
        free = c[1:] == 0
        for s, e in _runs(free):
            if e - s >= island_size:
                out.append((seq, s + 1, e))
    return out


@dataclasses.dataclass
class BackboneSegment:
    """A column range where all sequences are densely present."""

    interval_index: int
    col_start: int
    col_end: int  # half-open
    lefts: np.ndarray   # per-seq leftmost positions (0 absent)
    rights: np.ndarray


def simple_find_backbone(
    ivs: IntervalList, min_bb_length: int, max_gap_length: int
) -> List[BackboneSegment]:
    """Column ranges where every sequence has no gap run > max_gap_length and
    each sequence covers >= min_bb_length bases
    (simpleFindBackbone, src/mauveAligner.cpp:822)."""
    out: List[BackboneSegment] = []
    for k, iv in enumerate(ivs.intervals):
        if iv.multiplicity() < 2:
            continue
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        bad = np.zeros(iv.n_cols, bool)
        for s in present:
            for a, b in _runs(~iv.aln[s]):
                if b - a > max_gap_length:
                    bad[a:b] = True
        pos = {s: _col_pos(iv, s) for s in present}
        for a, b in _runs(~bad):
            lens = [int(iv.aln[s, a:b].sum()) for s in present]
            if min(lens, default=0) < min_bb_length:
                continue
            lefts = np.zeros(iv.n_seqs, np.int64)
            rights = np.zeros(iv.n_seqs, np.int64)
            for s in present:
                p = np.abs(pos[s][a:b])
                p = p[p > 0]
                if len(p):
                    lefts[s], rights[s] = int(p.min()), int(p.max())
            out.append(BackboneSegment(k, int(a), int(b), lefts, rights))
    return out


def write_backbone(segments: List[BackboneSegment], out: Union[str, TextIO], n_seqs: int) -> None:
    """Tab-separated backbone coordinate file (outputBackbone format:
    per segment, per-seq left/right coordinate columns)."""
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_backbone(segments, fh, n_seqs)
            return
    fh = out
    fh.write("\t".join(f"seq{i}_leftend\tseq{i}_rightend" for i in range(n_seqs)) + "\n")
    for seg in segments:
        cells = []
        for s in range(n_seqs):
            cells.append(str(int(seg.lefts[s])))
            cells.append(str(int(seg.rights[s])))
        fh.write("\t".join(cells) + "\n")


def coverage_fraction(ivs: IntervalList, seq_lengths: Sequence[int]) -> np.ndarray:
    """Fraction of each genome covered by multiplicity>=2 intervals
    (calculateCoverage semantics, src/calculateCoverage.cpp:21)."""
    n = ivs.n_seqs
    out = np.zeros(n)
    for seq in range(n):
        glen = seq_lengths[seq]
        if glen == 0:
            continue
        covered = np.zeros(glen + 1, bool)
        for iv in ivs.intervals:
            if iv.multiplicity() >= 2 and iv.starts[seq] != 0:
                l = int(abs(iv.starts[seq]))
                r = l + int(iv.aln[seq].sum())
                covered[l - 1 : r - 1] = True
        out[seq] = covered[:glen].mean()
    return out
