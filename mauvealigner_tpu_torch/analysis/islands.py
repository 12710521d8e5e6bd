"""Island and simple-backbone detection (L6a).

Equivalents of libMems Islands.h: simpleFindIslands, findIslandsBetweenLCBs,
simpleFindBackbone (reference call sites src/mauveAligner.cpp:809-850,
src/pairCompare.cpp:42).

An *island* is a region inside an LCB where one sequence has a run of
unaligned (gap-opposed) characters longer than a threshold — candidate
horizontally-transferred / strain-specific sequence.  *Backbone* is the
complement: column ranges where every sequence is present for at least
min_bb_length with gaps shorter than max_gap.

The three finders read each present row of an interval once, into its table
of gap runs (``_GapRuns``), and answer everything else with arithmetic over
runs: a 4.6 Mbp row with a few thousand indels is a few thousand runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.utils import timing


@dataclasses.dataclass
class Island:
    seq_i: int
    seq_j: int
    left_i: int
    right_i: int
    left_j: int
    right_j: int


class _GapRuns:
    """One alignment row's maximal gap runs, found in one pass over the row.

    ``starts[k]``/``ends[k]`` bound run k (half-open columns; ``starts`` ends
    with the sentinel n_cols) and ``before[k]`` counts the gap columns of
    the runs before it.  Positions are those of
    ``score_alignment._interval_positions``: the base of 1-based rank k sits
    at |start| + k - 1, or |start| + length - k on the reverse strand.
    """

    def __init__(self, iv: Interval, seq: int) -> None:
        row = iv.aln[seq]
        n = row.size
        starts = ends = np.zeros(0, np.int64)
        if n:
            edges = np.flatnonzero(row[1:] != row[:-1]) + 1
            bounds = np.concatenate(([0], edges, [n]))
            first = 1 if row[0] else 0  # the runs alternate, bases then gaps
            starts, ends = bounds[first:-1:2], bounds[first + 1::2]
        self.starts = np.append(starts, n).astype(np.int64)
        self.ends = ends.astype(np.int64)
        self.before = np.append(0, np.cumsum(ends - starts)).astype(np.int64)
        self.length = n - int(self.before[-1])  # bases in the row
        self.left = abs(int(iv.starts[seq]))
        self.forward = int(iv.starts[seq]) > 0

    def rank(self, cols: np.ndarray) -> np.ndarray:
        """The row's bases before each column (0 <= col <= n_cols)."""
        k = np.searchsorted(self.ends, cols, side="right")
        return cols - self.before[k] - np.maximum(cols - self.starts[k], 0)

    def pos(self, ranks: np.ndarray) -> np.ndarray:
        """Genome position of the base of each 1-based rank; 0 where the row
        has no such base."""
        p = self.left + ranks - 1 if self.forward else self.left + self.length - ranks
        return np.where((ranks >= 1) & (ranks <= self.length), p, 0)


def _row_tables(iv: Interval) -> Dict[int, _GapRuns]:
    """The gap-run table of each present row of `iv`, counted as work."""
    tables = {s: _GapRuns(iv, s) for s in np.flatnonzero(iv.starts != 0).tolist()}
    timing.GLOBAL.add("island_row_tables", float(len(tables)))
    timing.GLOBAL.add("island_gap_runs", float(sum(len(t.ends) for t in tables.values())))
    return tables


def simple_find_islands(
    ivs: IntervalList, island_size: int
) -> List[Island]:
    """Per sequence pair: runs of >= island_size columns where one sequence
    is gapped and the other is not (simpleFindIslands semantics).

    The reference scans the pairwise projection (both-gap columns dropped),
    so an island of one sequence against the other continues across columns
    a THIRD sequence inserted: it is the other's bases inside one maximal
    gap run of the gapped sequence."""
    out: List[Island] = []
    for iv in ivs.intervals:
        if iv.multiplicity() < 2:
            continue
        tables = _row_tables(iv)
        present = list(tables)
        for ai in range(len(present)):
            for bi in range(ai + 1, len(present)):
                i, j = present[ai], present[bi]
                for gapped, other in ((i, j), (j, i)):
                    g, o = tables[gapped], tables[other]
                    lo, hi = o.rank(g.starts[:-1]), o.rank(g.ends)
                    keep = np.flatnonzero(hi - lo >= max(island_size, 1))
                    if not keep.size:
                        continue
                    lo, hi = lo[keep], hi[keep]
                    # the gapped sequence's bases before the run: the island
                    # lies between its bases of ranks r and r + 1
                    r = g.starts[keep] - g.before[keep]
                    pj = np.stack([o.pos(lo + 1), o.pos(hi)])
                    for li, ri, lj, rj in zip(
                        g.pos(r).tolist(), g.pos(r + 1).tolist(),
                        pj.min(axis=0).tolist(), pj.max(axis=0).tolist(),
                    ):
                        out.append(Island(gapped, other, li, ri, lj, rj))
    return out


def find_islands_between_lcbs(
    ivs: IntervalList, seq_lengths: Sequence[int], island_size: int
) -> List[Tuple[int, int, int]]:
    """Unaligned inter-LCB regions >= island_size: (seq, left, right)
    (findIslandsBetweenLCBs semantics, src/mauveAligner.cpp:845), the
    stretches of 1..glen that no multiplicity >= 2 interval covers."""
    spans: Dict[int, List[Tuple[int, int]]] = {}
    for iv in ivs.intervals:
        if iv.multiplicity() < 2:
            continue
        for seq, t in _row_tables(iv).items():
            if t.length:
                spans.setdefault(seq, []).append((t.left, t.left + t.length - 1))
    out = []
    for seq in range(ivs.n_seqs):
        lr = np.array(sorted(spans.get(seq, [])), np.int64).reshape(-1, 2)
        # the spans cover 1..reach[k] before span k, so the stretch before
        # it is reach[k] + 1 .. l[k] - 1, and the last one runs to glen
        reach = np.append(0, np.maximum.accumulate(lr[:, 1]))
        free_l = reach + 1
        free_r = np.append(lr[:, 0] - 1, seq_lengths[seq])
        keep = free_r - free_l + 1 >= max(island_size, 1)
        out.extend((seq, l, r) for l, r in zip(free_l[keep].tolist(), free_r[keep].tolist()))
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
        tables = _row_tables(iv)
        # the union of every present row's long gap runs, as sorted blocks;
        # the segments are the column ranges between the blocks
        long_runs = [(t.starts[:-1], t.ends) for t in tables.values()]
        bs = np.concatenate([s[e - s > max_gap_length] for s, e in long_runs])
        be = np.concatenate([e[e - s > max_gap_length] for s, e in long_runs])
        order = np.argsort(bs, kind="stable")
        bs, reach = bs[order], np.maximum.accumulate(be[order])
        # a block opens where a run starts past the reach of every run before
        opens = np.flatnonzero(np.append(True, bs[1:] > reach[:-1])[: len(bs)])
        seg_a = np.concatenate(([0], reach[opens[1:] - 1], reach[-1:]))
        seg_b = np.append(bs[opens], iv.n_cols)
        nonempty = seg_b > seg_a
        seg_a, seg_b = seg_a[nonempty], seg_b[nonempty]
        lo = {s: t.rank(seg_a) for s, t in tables.items()}
        hi = {s: t.rank(seg_b) for s, t in tables.items()}
        lens = np.stack([hi[s] - lo[s] for s in tables])
        keep = np.flatnonzero(lens.min(axis=0) >= min_bb_length)
        lefts = np.zeros((len(keep), iv.n_seqs), np.int64)
        rights = np.zeros((len(keep), iv.n_seqs), np.int64)
        for s, t in tables.items():
            l, h = lo[s][keep], hi[s][keep]
            p = np.stack([t.pos(l + 1), t.pos(h)])
            lefts[:, s] = np.where(h > l, p.min(axis=0), 0)
            rights[:, s] = np.where(h > l, p.max(axis=0), 0)
        for m, (a, b) in enumerate(zip(seg_a[keep].tolist(), seg_b[keep].tolist())):
            out.append(BackboneSegment(k, a, b, lefts[m], rights[m]))
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
