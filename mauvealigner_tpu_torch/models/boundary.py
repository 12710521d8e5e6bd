"""Gapped LCB boundary extension.

The reference extends LCB coverage beyond the outermost anchors: Aligner's
gapped LCB extension (SetMaxExtensionIterations, src/mauveAligner.cpp:687-690)
and ProgressiveAligner's full-length alignment both push LCB boundaries into
the flanking unanchored territory with gapped alignment, relying on the
homology HMM (detectAndApplyBackbone, src/progressiveMauve.cpp:239) to unalign
non-homologous overreach.  Without this step, the region between a genome end
(or a neighboring LCB) and the outermost anchor is never aligned at all —
a pure sensitivity loss.

Batched design: flank regions of every interval edge are collected globally,
bucketed, and aligned in ONE batched closure pass (the same jitted Gotoh
entry points and shape buckets as the inter-anchor closure, so no new
compilations).  Uncovered runs shared by two neighboring intervals are split
at the midpoint so extensions never overlap and the tiling invariant holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.ops import dp

# (interval index, genome) -> (lo, hi) inclusive forward-strand allocation
_Alloc = Dict[Tuple[int, int], Tuple[int, int]]


def _allocate_flanks(
    ivl: IntervalList, genomes: Sequence[Genome], max_flank: int
) -> Tuple[_Alloc, _Alloc]:
    """Split every uncovered run between the intervals that flank it.

    Returns (alloc_gleft, alloc_gright): genome-forward left/right flank
    allocation per (interval, genome).  A run bounded by two intervals is
    split at its midpoint; each share is capped at max_flank keeping the
    portion adjacent to its interval.
    """
    alloc_gleft: _Alloc = {}
    alloc_gright: _Alloc = {}
    n = len(genomes)
    for g in range(n):
        extents = []
        for idx, iv in enumerate(ivl.intervals):
            if iv.starts[g] == 0:
                continue
            L = int(abs(iv.starts[g]))
            R = L + int(iv.aln[g].sum()) - 1
            extents.append((L, R, idx))
        if not extents:
            continue
        extents.sort()
        glen = len(genomes[g])
        # runs: before first, between consecutive, after last
        prev_R, prev_idx = 0, -1
        for L, R, idx in extents + [(glen + 1, glen + 1, -1)]:
            run_lo, run_hi = prev_R + 1, L - 1
            if run_lo <= run_hi:
                run_len = run_hi - run_lo + 1
                if prev_idx >= 0 and idx >= 0:
                    half = run_len // 2
                    left_take = min(half, max_flank)
                    right_take = min(run_len - half, max_flank)
                elif prev_idx >= 0:
                    left_take, right_take = min(run_len, max_flank), 0
                else:
                    left_take, right_take = 0, min(run_len, max_flank)
                if prev_idx >= 0 and left_take > 0:
                    alloc_gright[(prev_idx, g)] = (run_lo, run_lo + left_take - 1)
                if idx >= 0 and right_take > 0:
                    alloc_gleft[(idx, g)] = (run_hi - right_take + 1, run_hi)
            prev_R, prev_idx = R, idx
    return alloc_gleft, alloc_gright


def _extract(genome: Genome, lo: int, hi: int, strand: int) -> np.ndarray:
    length = hi - lo + 1
    return genome.sub_codes_signed(strand * lo, length).astype(np.int64)


def extend_interval_boundaries(
    ivl: IntervalList,
    genomes: Sequence[Genome],
    plan=None,
    subst: Optional[np.ndarray] = None,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
    max_flank: int = 1024,
    device="cuda",
) -> IntervalList:
    """Extend every interval's alignment outward into adjacent uncovered
    territory (both alignment edges), in one batched closure pass on
    `device`.

    Only flank groups where >= 2 sequences have material are aligned; runs
    claimed by no extension stay for add_unaligned_intervals.  Intervals are
    rebuilt in place order; starts shift to keep the tiling invariant.
    """
    n = len(genomes)
    alloc_gleft, alloc_gright = _allocate_flanks(ivl, genomes, max_flank)
    if not alloc_gleft and not alloc_gright:
        return ivl

    groups: List[List[np.ndarray]] = []
    group_ref: List[Tuple[int, str]] = []  # (interval idx, 'L'|'R')
    flank_lens: Dict[Tuple[int, str], np.ndarray] = {}
    for idx, iv in enumerate(ivl.intervals):
        for side in ("L", "R"):
            regions = [np.zeros(0, np.int64)] * n
            lens = np.zeros(n, np.int64)
            for g in range(n):
                s = int(np.sign(iv.starts[g]))
                if s == 0:
                    continue
                # alignment-left of a forward row is its genome-left flank;
                # for a reverse row it is the genome-right flank (revcomp)
                if (side == "L") == (s > 0):
                    span = alloc_gleft.get((idx, g))
                else:
                    span = alloc_gright.get((idx, g))
                if span is None:
                    continue
                regions[g] = _extract(genomes[g], span[0], span[1], s)
                lens[g] = len(regions[g])
            if (lens > 0).sum() >= 2:
                groups.append(regions)
                group_ref.append((idx, side))
                flank_lens[(idx, side)] = lens

    if not groups:
        return ivl

    alns = closure.hierarchical_align_region_groups(
        groups,
        plan,
        subst=subst if subst is not None else dp.HOXD70,
        gap_open=gap_open,
        gap_extend=gap_extend,
        max_len=max(max_flank, 1),
        device=device,
    )
    table = dict(zip(group_ref, alns))

    new_intervals: List[Interval] = []
    for idx, iv in enumerate(ivl.intervals):
        left_aln = table.get((idx, "L"))
        right_aln = table.get((idx, "R"))
        if left_aln is None and right_aln is None:
            new_intervals.append(iv)
            continue
        blocks = []
        if left_aln is not None and left_aln.shape[1]:
            blocks.append(left_aln)
        blocks.append(iv.aln)
        if right_aln is not None and right_aln.shape[1]:
            blocks.append(right_aln)
        aln_new = np.concatenate(blocks, axis=1)
        starts_new = iv.starts.copy()
        for g in range(n):
            s = int(np.sign(iv.starts[g]))
            if s == 0:
                continue
            al = int(flank_lens[(idx, "L")][g]) if left_aln is not None else 0
            ar = int(flank_lens[(idx, "R")][g]) if right_aln is not None else 0
            if s > 0:
                # alignment-left flank prepends genome-left bases
                starts_new[g] -= al
            else:
                # alignment-right flank of a reverse row prepends
                # genome-left bases: leftmost coordinate falls by ar
                starts_new[g] += ar
        new_intervals.append(Interval(starts_new, aln_new))
    return IntervalList(
        genomes=list(ivl.genomes),
        intervals=new_intervals,
        seq_filenames=list(ivl.seq_filenames),
        backbone_filename=ivl.backbone_filename,
    )
