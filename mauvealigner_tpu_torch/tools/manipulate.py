"""Alignment manipulation / projection tools (SURVEY.md §2.2).

Function-per-reference-tool; CLI glue lives in cli.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import Genome


# -- stripSubsetLCBs (src/stripSubsetLCBs.cpp:31) ---------------------------

def strip_subset_lcbs(
    ivs: IntervalList,
    min_seqs: int,
    min_length: int,
    sample: Optional[int] = None,
    seed: int = 37,
) -> IntervalList:
    """Keep blocks covering >= min_seqs sequences with >= min_length columns;
    optionally random-subsample `sample` of them."""
    kept = [
        iv
        for iv in ivs.intervals
        if iv.multiplicity() >= min_seqs and iv.n_cols >= min_length
    ]
    if sample is not None and sample < len(kept):
        rng = np.random.default_rng(seed)
        idx = sorted(rng.choice(len(kept), size=sample, replace=False))
        kept = [kept[i] for i in idx]
    return IntervalList(
        genomes=ivs.genomes, intervals=kept, seq_filenames=list(ivs.seq_filenames)
    )


def strip_subset_lcbs_bbcols(
    ivs: IntervalList,
    segments,
    min_block_length: int = 0,
    min_genomes: Optional[int] = None,
    sample_kb: int = 0,
    seed: int = 37,
) -> IntervalList:
    """Reference stripSubsetLCBs semantics (src/stripSubsetLCBs.cpp:125-167):
    crop each backbone-column segment with >= min_genomes members out of
    its interval, keep crops whose MEAN per-sequence length (over all
    sequences, integer division) reaches min_block_length, optionally
    random-subsample blocks until ~sample_kb cumulative alignment columns."""
    n = ivs.n_seqs
    if min_genomes is None:
        min_genomes = n
    kept = []
    for seg in segments:
        if len(seg.seqs) < min_genomes:
            continue
        iv = ivs.intervals[seg.interval_index]
        sub = iv.column_slice(seg.col_start, seg.col_end)
        avglen = int(sub.seq_lengths().sum()) // n
        if avglen >= min_block_length:
            kept.append(sub)
    if sample_kb and kept:
        rng = np.random.default_rng(seed)
        sampled = set()
        cur_kb = 0.0
        # reference quirk: the loop counter also adds 1 kb per draw
        # (src/stripSubsetLCBs.cpp:149)
        while cur_kb < sample_kb and len(sampled) < len(kept):
            block = int(rng.integers(0, len(kept)))
            cur_kb += 1.0
            if block in sampled:
                continue
            sampled.add(block)
            cur_kb += kept[block].n_cols / 1000.0
        kept = [kept[i] for i in sorted(sampled)]
    return IntervalList(
        genomes=ivs.genomes, intervals=kept, seq_filenames=list(ivs.seq_filenames)
    )


# -- alignmentProjector (src/alignmentProjector.cpp:30) ---------------------

def alignment_projector(ivs: IntervalList, seq_indices: Sequence[int]) -> IntervalList:
    return ivs.projection(seq_indices)


# -- projectAndStrip (src/projectAndStrip.cpp:33) ---------------------------

def project_and_strip(
    ivs: IntervalList,
    seq_indices: Sequence[int],
    min_seqs: int = 2,
    min_length: int = 1,
) -> IntervalList:
    return strip_subset_lcbs(ivs.projection(seq_indices), min_seqs, min_length)


# -- extractSubalignments (src/extractSubalignments.cpp:32) -----------------

def extract_subalignment(
    ivs: IntervalList, seq: int, left: int, right: int
) -> List[Interval]:
    """Sub-blocks covering [left, right] of sequence `seq` (1-based)."""
    out = []
    for iv in ivs.intervals:
        if iv.starts[seq] == 0:
            continue
        from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

        # intersect both predicates: reverse-strand rows have DESCENDING
        # positions, so first-at-or-after / last-at-or-before would span
        # the whole interval
        pcol = np.abs(_interval_positions(iv, seq))
        sel = np.nonzero((pcol >= left) & (pcol <= right) & (pcol > 0))[0]
        if not len(sel):
            continue
        c1, c2 = int(sel[0]), int(sel[-1])
        sub_aln = iv.aln[:, c1 : c2 + 1]
        starts = np.zeros(iv.n_seqs, np.int64)
        for s in range(iv.n_seqs):
            if iv.starts[s] == 0 or not sub_aln[s].any():
                continue
            pos = _interval_positions(iv, s)[c1 : c2 + 1]
            nz = pos[pos != 0]
            sign = 1 if nz[0] > 0 else -1
            starts[s] = sign * int(np.abs(nz).min())
        keep = sub_aln.any(axis=0)
        out.append(Interval(starts, sub_aln[:, keep]))
    return out


# -- getAlignmentWindows (src/getAlignmentWindows.cpp:26) -------------------

def alignment_windows(
    ivs: IntervalList, window_cols: int, step_cols: Optional[int] = None
) -> List[Interval]:
    """Sliding column windows over every interval."""
    step = step_cols or window_cols
    out = []
    for iv in ivs.intervals:
        for a in range(0, max(iv.n_cols - window_cols + 1, 1), step):
            b = min(a + window_cols, iv.n_cols)
            sub = iv.aln[:, a:b]
            starts = np.zeros(iv.n_seqs, np.int64)
            from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

            for s in range(iv.n_seqs):
                if iv.starts[s] == 0 or not sub[s].any():
                    continue
                pos = _interval_positions(iv, s)[a:b]
                nz = pos[pos != 0]
                starts[s] = (1 if nz[0] > 0 else -1) * int(np.abs(nz).min())
            out.append(Interval(starts, sub))
    return out


# -- joinAlignmentFiles (src/joinAlignmentFiles.cpp) ------------------------

def join_alignment_files(lists: Sequence[IntervalList]) -> IntervalList:
    if not lists:
        raise ValueError("nothing to join")
    n = lists[0].n_seqs
    for l in lists[1:]:
        if l.n_seqs != n:
            raise ValueError("sequence counts differ between alignment files")
    return IntervalList(
        genomes=lists[0].genomes,
        intervals=[iv for l in lists for iv in l.intervals],
        seq_filenames=list(lists[0].seq_filenames),
    )


# -- stripGapColumns (src/stripGapColumns.cpp:16) ---------------------------

def strip_gap_columns(ivs: IntervalList) -> IntervalList:
    return IntervalList(
        genomes=ivs.genomes,
        intervals=[iv.strip_gap_columns() for iv in ivs.intervals],
        seq_filenames=list(ivs.seq_filenames),
    )


# -- coordinateTranslate (src/coordinateTranslate.cpp:16) -------------------

def coordinate_translate(
    ivs: IntervalList, seq: int, position: int
) -> Optional[Tuple[int, int]]:
    """sequence position -> (interval index, column)."""
    for k, iv in enumerate(ivs.intervals):
        col = iv.position_to_column(seq, position)
        if col >= 0:
            return k, col
    return None


# -- transposeCoordinates (src/transposeCoordinates.cpp:21) -----------------

def _masked_region_starts(regions: np.ndarray):
    """Sorted removed regions -> (masked-coordinate starts, cumulative
    removed lengths) — the junction table transpose_positions uses."""
    order = np.argsort(regions[:, 0])
    reg_starts = regions[order, 0]
    cum = np.cumsum(regions[order, 1])
    masked_starts = reg_starts - np.concatenate([[0], cum[:-1]])
    return masked_starts, cum


def transpose_coordinates(ml, regions_per_seq: Sequence[np.ndarray]):
    """Transpose match coordinates from masked (N-runs removed) space back
    to original coordinates.  A match whose span crosses a removed region's
    junction is SPLIT there first — shifting only its left end would make it
    claim the removed bases as aligned sequence."""
    from mauvealigner_tpu_torch.core.match import MatchList
    from mauvealigner_tpu_torch.genome.sequence import transpose_positions

    junctions = [
        _masked_region_starts(r)[0] if len(r) else np.zeros(0, np.int64)
        for r in regions_per_seq
    ]
    rows: list = []
    lens: list = []
    for i in range(len(ml)):
        length = int(ml.lengths[i])
        cuts = set()
        for s in range(ml.n_seqs):
            p = int(ml.starts[i, s])
            if p == 0 or not len(junctions[s]):
                continue
            left = abs(p)
            for m in junctions[s]:
                # junction between masked genome positions m-1 and m
                off = int(m - left) if p > 0 else int(left + length - m)
                if 0 < off < length:
                    cuts.add(off)
        segs = [0] + sorted(cuts) + [length]
        for a, b in zip(segs[:-1], segs[1:]):
            row = np.zeros(ml.n_seqs, np.int64)
            for s in range(ml.n_seqs):
                p = int(ml.starts[i, s])
                if p == 0:
                    continue
                # match-space [a, b) -> genome-left of the segment
                row[s] = p + a if p > 0 else -(abs(p) + length - b)
            rows.append(row)
            lens.append(b - a)
    starts = np.array(rows, np.int64).reshape(len(rows), ml.n_seqs)
    lengths = np.array(lens, np.int64)
    for s in range(ml.n_seqs):
        starts[:, s] = transpose_positions(starts[:, s], lengths, regions_per_seq[s])
    return MatchList(starts, lengths)


# -- sortContigs (src/sortContigs.cpp) --------------------------------------

def sort_contigs(
    draft: Genome, reference_order: List[Tuple[int, int, int]]
) -> Tuple[Genome, List[Tuple[str, int]]]:
    """Reorder/orient draft contigs given (contig_index, strand, ref_pos)
    placements; unplaced contigs are appended (placement loop
    src/sortContigs.cpp:74-145).  Returns (reordered genome, placement log).
    """
    from mauvealigner_tpu_torch.genome.sequence import revcomp_ascii

    placed = sorted(reference_order, key=lambda t: t[2])
    used = set()
    parts = []
    log: List[Tuple[str, int]] = []
    new_contigs = []
    offset = 0
    from mauvealigner_tpu_torch.genome.sequence import Contig

    for idx, strand, _ in placed:
        if idx in used:
            continue
        used.add(idx)
        c = draft.contigs[idx]
        chunk = draft.seq[c.offset : c.offset + c.length]
        if strand < 0:
            chunk = revcomp_ascii(chunk)
        parts.append(chunk)
        new_contigs.append(Contig(c.name, c.length, offset))
        offset += c.length
        log.append((c.name, strand))
    for idx, c in enumerate(draft.contigs):
        if idx in used:
            continue
        parts.append(draft.seq[c.offset : c.offset + c.length])
        new_contigs.append(Contig(c.name, c.length, offset))
        offset += c.length
        log.append((c.name, 0))
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return Genome(seq, contigs=new_contigs, name=draft.name + ".reordered"), log


def contig_placements_from_lcbs(
    draft: Genome, lcbs, draft_seq_index: int, ref_seq_index: int = 0
) -> List[Tuple[int, int, int]]:
    """Derive (contig, strand, order) placements with the reference's
    placement walk (src/sortContigs.cpp:74-128): LCBs are visited in
    reference coordinate order (the left-to-right adjacency walk); each LCB
    places EVERY draft contig its span overlaps, walking the contig range
    forward or backward with the LCB's relative orientation; the first
    placement of a contig wins (placed_contigs check, :108-110)."""
    order = sorted(
        (i for i in range(len(lcbs))
         if lcbs[i].lefts[draft_seq_index] != 0 and lcbs[i].lefts[ref_seq_index] != 0),
        key=lambda i: int(lcbs[i].lefts[ref_seq_index]),
    )
    out: List[Tuple[int, int, int]] = []
    pos = 0
    for i in order:
        lcb = lcbs[i]
        l = int(lcb.lefts[draft_seq_index])
        r = int(lcb.rights[draft_seq_index])
        # the reference walks [lend, rend-1] (:81): the one-base trim keeps
        # a match that barely spills over a contig boundary from dragging
        # the next contig along.  Our matches are base-level maximal (chance
        # agreement extends a few bases past the true boundary), so trim a
        # little deeper on both ends: a boundary contig joins the range only
        # when the LCB overlaps it by > 15 bases.
        trim = min(15, (r - l) // 2)
        left_probe = l + trim
        # never let the right probe cross left of the left probe (odd
        # spans under 32 bases): the LCB must still place its contig
        right_probe = max(left_probe, r - trim - 1)
        cl, _ = draft.global_to_local(max(1, min(left_probe, len(draft))))
        cr, _ = draft.global_to_local(max(1, min(right_probe, len(draft))))
        forward = (
            int(lcb.strands[draft_seq_index]) * int(lcb.strands[ref_seq_index])
        ) >= 0
        walk = range(cl, cr + 1) if forward else range(cr, cl - 1, -1)
        for ci in walk:
            out.append((ci, 1 if forward else -1, pos))
            pos += 1
    return out


# -- unalign (src/unalign.cpp) ----------------------------------------------

def unalign_islands(ivs: IntervalList, segments) -> IntervalList:
    """Remove non-backbone (island) sequence from the alignment by applying
    backbone segments (--bbcols mode of the unalign CLI)."""
    from mauvealigner_tpu_torch.analysis.backbone import apply_backbone

    return apply_backbone(ivs, segments)


def unalign_sequences(ivs: IntervalList, out) -> None:
    """Reconstruct the input sequences from an alignment
    (src/unalign.cpp:14-80): per genome, concatenate its block texts in
    coordinate order (reverse blocks revcomped back to forward strand),
    strip gaps, write one Multi-FastA record per genome."""
    from mauvealigner_tpu_torch.genome.sequence import revcomp_ascii

    names = ivs.filenames()
    for s in range(ivs.n_seqs):
        blocks = sorted(
            (iv for iv in ivs.intervals if iv.starts[s] != 0),
            key=lambda iv: abs(int(iv.starts[s])),
        )
        parts = []
        for iv in blocks:
            text = iv.aligned_text(ivs.genomes, s).replace("-", "")
            chunk = np.frombuffer(text.encode(), np.uint8)
            if iv.starts[s] < 0:
                chunk = revcomp_ascii(chunk)
            parts.append(chunk)
        seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        from mauvealigner_tpu_torch.tools.common import write_fasta_row

        write_fasta_row(out, names[s] or f"seq{s}", seq.tobytes().decode("ascii"))
