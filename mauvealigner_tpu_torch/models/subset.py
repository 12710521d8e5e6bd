"""Subset-LCB detection: align regions shared by only a subset of genomes.

ProgressiveMauve's anchors are computed pairwise and translated up the guide
tree, so segments present in a strict subset of genomes (e.g. a gene shared
by one clade) still anchor.  The n-way core pass here misses those; this
module recovers them: for every internal guide-tree clade, the still-
unaligned regions of the clade's genomes are re-anchored among themselves
and aligned, producing subset intervals.

Region extraction concatenates each genome's uncovered regions with N-run
spacers (no seed window can span a spacer), and maps match coordinates back
through a per-region offset table.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models.lcb import greedy_breakpoint_elimination

_SPACER = 64  # >= max seed length


def uncovered_regions(ivl: IntervalList, seq: int) -> List[Tuple[int, int]]:
    """1-based [left, right] regions of `seq` not covered by any
    multiplicity>=2 interval."""
    glen = len(ivl.genomes[seq])
    cov = np.zeros(glen + 2, np.int64)
    for iv in ivl.intervals:
        if iv.multiplicity() >= 2 and iv.starts[seq] != 0:
            l = max(1, abs(int(iv.starts[seq])))
            r = min(glen, l + int(iv.aln[seq].sum()) - 1)
            if r < l:
                continue
            cov[l] += 1
            cov[r + 1] -= 1
    c = np.cumsum(cov[: glen + 1])
    free = c[1:] == 0
    d = np.diff(np.concatenate([[0], free.view(np.int8), [0]]))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0]
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def _build_subgenome(genome: Genome, regions: List[Tuple[int, int]]):
    """Concatenate regions with N spacers; returns (sub Genome, offsets) where
    offsets[i] = (sub_start_0based, genome_left, length)."""
    parts = []
    offsets = []
    pos = 0
    spacer = np.full(_SPACER, ord("N"), np.uint8)
    for l, r in regions:
        chunk = genome.seq[l - 1 : r]
        offsets.append((pos, l, len(chunk)))
        parts.append(chunk)
        parts.append(spacer)
        pos += len(chunk) + _SPACER
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return Genome(seq, name=genome.name + "_sub"), offsets


def _map_back(signed_pos: np.ndarray, lengths: np.ndarray, offsets) -> np.ndarray:
    """Map signed sub-genome starts back to original genome coordinates;
    0 where a match does not fit inside one region."""
    if not offsets:
        return np.zeros_like(signed_pos)
    subs = np.array([o[0] for o in offsets], np.int64)
    lefts = np.array([o[1] for o in offsets], np.int64)
    lens = np.array([o[2] for o in offsets], np.int64)
    out = np.zeros_like(signed_pos)
    nz = signed_pos != 0
    p0 = np.abs(signed_pos[nz]) - 1  # 0-based sub position
    idx = np.searchsorted(subs, p0, side="right") - 1
    idx = np.clip(idx, 0, len(subs) - 1)
    inside = (p0 >= subs[idx]) & (p0 + lengths[nz] <= subs[idx] + lens[idx])
    mapped = lefts[idx] + (p0 - subs[idx])
    vals = np.where(inside, np.sign(signed_pos[nz]) * mapped, 0)
    out[nz] = vals
    return out


def clades_postorder(tree) -> List[List[int]]:
    """Leaf-index sets of internal nodes, smallest first, root excluded."""
    out: List[List[int]] = []

    def rec(node) -> List[int]:
        if node.is_leaf:
            return [int(node.name)]
        leaves: List[int] = []
        for c in node.children:
            leaves.extend(rec(c))
        out.append(sorted(leaves))
        return leaves

    all_leaves = rec(tree)
    return [c for c in sorted(out, key=len) if 1 < len(c) < len(all_leaves)]


def subset_lcb_pass(
    genomes: Sequence[Genome],
    ivl: IntervalList,
    tree,
    seed,
    closure_fn,
    min_region: int = 64,
    lcb_weight: Optional[float] = None,
    device="cuda",
) -> Tuple[IntervalList, int]:
    """Anchor + align uncovered regions within every guide-tree clade.

    closure_fn(match_list, lcbs) -> List[Interval] performs the gapped
    closure (typically MauveAligner.build_intervals).  The anchor search
    runs on `device`.  Returns (interval list with subset intervals added,
    number added).
    """
    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.ops import matchops

    n = len(genomes)
    added = 0
    intervals = list(ivl.intervals)
    work = IntervalList(genomes=list(genomes), intervals=intervals,
                        seq_filenames=list(ivl.seq_filenames))
    for clade in clades_postorder(tree):
        regions = {s: uncovered_regions(work, s) for s in clade}
        active = [
            s
            for s in clade
            if sum(r - l + 1 for l, r in regions[s]) >= min_region
        ]
        if len(active) < 2:
            continue
        subs = {}
        offs = {}
        for s in active:
            regs = [(l, r) for l, r in regions[s] if r - l + 1 >= seed.length]
            if not regs:
                continue
            subs[s], offs[s] = _build_subgenome(genomes[s], regs)
        live = sorted(subs)
        if len(live) < 2:
            continue
        sub_genomes = [subs[s] for s in live]
        smls = [build_mer_list_device(g, seed, device) for g in sub_genomes]
        ml = matchops.find_multi_mums_device(
            sub_genomes, smls, seed_length=seed.length
        )
        ml = ml.multiplicity_filter(len(live))
        if len(ml) == 0:
            continue
        # map back to original coordinates; drop spacer-crossing matches
        rows = np.zeros((len(ml), n), np.int64)
        ok = np.ones(len(ml), bool)
        for col, s in enumerate(live):
            mapped = _map_back(ml.starts[:, col], ml.lengths, offs[s])
            rows[:, s] = mapped
            ok &= mapped != 0
        if not ok.any():
            continue
        sub_ml = MatchList(rows[ok], ml.lengths[ok]).dedup().eliminate_overlaps()
        sub_ml = sub_ml.multiplicity_filter(len(live))
        weight = lcb_weight if lcb_weight is not None else seed.weight * 3 * len(live)
        kept, lcbs = greedy_breakpoint_elimination(sub_ml, weight)
        if not lcbs:
            continue
        new_ivs = closure_fn(kept, lcbs)
        for iv in new_ivs:
            work.intervals.append(iv)
            added += 1
    return work, added
