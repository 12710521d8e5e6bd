"""Homology-HMM backbone detection and application (L6b).

Equivalent of libMems Backbone.h + HomologyHMM (reference driver:
applyBackbone, src/progressiveMauve.cpp:226-260): a 2-state pair-HMM
(Homologous / Unrelated) is posterior-decoded over the columns of every
pairwise projection of the alignment; sequence regions predicted Unrelated
to every partner are un-aligned; remaining dense regions form the backbone.

Parameter parity: transition priors iGoHomologous (pgh, default 1e-5) and
iGoUnrelated (pgu, default 1e-9) and the identity-adaptation knob (default
0.7) follow src/progressiveMauve.cpp:319-322; emissions are GC-adapted
(getAdaptedHoxdMatrixParameters / computeGC / adaptToPercentIdentity,
src/progressiveMauve.cpp:231-237).  The scan itself is the batched K4
forward-backward decode (ops/hmm.py), on the device every caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, TextIO, Tuple, Union
import time

import numpy as np
import torch

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.ops import hmm as hmm_ops

# column symbol classes; SYM_NONE marks both-gap columns of a pairwise
# projection — the reference scores the PROJECTED pair (both-gap columns
# removed), so they must be emission-neutral, not gap-emitting
SYM_MATCH, SYM_TRANSITION, SYM_TRANSVERSION, SYM_GAP, SYM_NONE = 0, 1, 2, 3, 4
N_SYMBOLS = 5        # symbol alphabet incl. SYM_NONE
N_EMIT_SYMBOLS = 4   # emission classes (SYM_NONE is emission-neutral)
STATE_H, STATE_U = 0, 1


@dataclasses.dataclass
class HmmParams:
    """Homology HMM parameters (Params equivalent)."""

    go_homologous: float = 1e-5   # U -> H transition (pgh)
    go_unrelated: float = 1e-9    # H -> U transition (pgu)
    emit_h: np.ndarray = None     # [4] symbol probs in Homologous state
    emit_u: np.ndarray = None     # [4] symbol probs in Unrelated state

    def log_trans(self) -> np.ndarray:
        t = np.array(
            [
                [1.0 - self.go_unrelated, self.go_unrelated],
                [self.go_homologous, 1.0 - self.go_homologous],
            ]
        )
        return np.log(t)

    def log_emit_table(self) -> np.ndarray:
        return np.log(np.stack([self.emit_h, self.emit_u]) + 1e-300)


def compute_gc(genomes: Sequence[Genome]) -> float:
    """GC fraction over all genomes (computeGC equivalent)."""
    gc = total = 0
    for g in genomes:
        codes = g.codes
        acgt = codes < 4
        total += int(acgt.sum())
        gc += int(((codes == 1) | (codes == 2)).sum())
    return gc / total if total else 0.5


def adapted_params(
    gc_content: float,
    identity: float = 0.7,
    go_homologous: float = 1e-5,
    go_unrelated: float = 1e-9,
    denovo: bool = False,
) -> HmmParams:
    """GC- and identity-adapted emission distributions
    (getAdaptedHoxdMatrixParameters + adaptToPercentIdentity equivalents).

    Homologous state: matches with probability `identity`; mismatches split
    2:1 transition:transversion; a modest gap mass.  Unrelated state:
    coincidental matches at the GC-dependent background rate
    p_match = 2*((gc/2)^2 + ((1-gc)/2)^2), heavy gap mass (unrelated regions
    align mostly against gaps).
    """
    gap_h = 0.05
    mism_h = max(1.0 - identity - gap_h, 1e-6)
    emit_h = np.array([identity, mism_h * 2 / 3, mism_h / 3, gap_h])
    if denovo:
        # de-novo flank extension re-ALIGNS the candidate regions, and a
        # global aligner manufactures coincidental matches from unrelated
        # sequence (measured: ~55% match, ~25-45% gap columns for random
        # inputs).  The unrelated state must absorb that alignment bias; the
        # gap fraction then carries the discrimination.
        gap_u = 0.30
        match_u = 0.55
        mism_u = 1.0 - gap_u - match_u
    else:
        p_bg = 2 * ((gc_content / 2) ** 2 + ((1 - gc_content) / 2) ** 2)
        gap_u = 0.4
        match_u = p_bg * (1 - gap_u)
        mism_u = (1 - gap_u) * (1 - p_bg)
    emit_u = np.array([match_u, mism_u * 0.5, mism_u * 0.5, gap_u])
    emit_h /= emit_h.sum()
    emit_u /= emit_u.sum()
    return HmmParams(go_homologous, go_unrelated, emit_h, emit_u)


_TRANSITION_PAIRS = {(0, 2), (2, 0), (1, 3), (3, 1)}  # A<->G, C<->T


def _build_symbol_lut() -> np.ndarray:
    """6x6 code-pair -> symbol class table (codes 0-3 bases, 4 N, 5 gap)."""
    lut = np.full((6, 6), SYM_GAP, np.int8)
    lut[5, 5] = SYM_NONE
    for a in range(4):
        for b in range(4):
            if a == b:
                lut[a, b] = SYM_MATCH
            elif (a, b) in _TRANSITION_PAIRS:
                lut[a, b] = SYM_TRANSITION
            else:
                lut[a, b] = SYM_TRANSVERSION
    return lut


SYMBOL_LUT = _build_symbol_lut()


def column_symbols(
    iv: Interval, genomes: Sequence[Genome], i: int, j: int
) -> np.ndarray:
    """Symbol class per column for the (i, j) pairwise projection.

    Columns where both are gapped get SYM_NONE (emission-neutral: the
    reference scores the PROJECTED pair, which does not contain them, so a
    long third-sequence insertion must not drive the pair into Unrelated).
    """
    ci = _signed_codes_row(iv, genomes, i)
    cj = _signed_codes_row(iv, genomes, j)
    return SYMBOL_LUT[ci, cj]


def _signed_codes_row(iv: Interval, genomes: Sequence[Genome], seq: int) -> np.ndarray:
    """Per-column base code (4=N, 5=gap/absent) in match-space orientation."""
    out = np.full(iv.n_cols, 5, np.int8)
    s = int(iv.starts[seq])
    if s == 0:
        return out
    length = int(iv.aln[seq].sum())
    codes = genomes[seq].sub_codes_signed(s, length).astype(np.int8)
    out[iv.aln[seq]] = codes
    return out


def pairwise_homology_posteriors(
    ivs: IntervalList,
    params: HmmParams,
    max_cols: int = 1 << 16,
    threshold: Optional[float] = None,
    device="cuda",
) -> Dict[Tuple[int, int, int], np.ndarray]:
    """P(Homologous) per column for every (interval, i, j) pairwise
    projection with both sequences present.  Batched through the K4 kernel
    with length bucketing.

    With `threshold` set, the comparison runs on the device and bool
    arrays come back — the backbone detector only consumes the thresholded
    posterior."""
    genomes = ivs.genomes
    overlap = 512
    # SYM_NONE (both-gap) columns are REMOVED before the decode — the
    # reference decodes the pairwise projection, which does not contain
    # them, so transition probability must not accrue across a long
    # third-sequence insertion.  Posteriors are scattered back to full
    # column space with forward-fill across the removed columns (the
    # projected decode's state carries over them; detect_backbone masks
    # those columns with iv.aln anyway).
    from mauvealigner_tpu_torch.utils import timing

    t0 = time.perf_counter()
    jobs = []  # (key, chunk_start_in_compact, symbols_chunk)
    compact_idx: Dict[Tuple[int, int, int], np.ndarray] = {}
    full_len: Dict[Tuple[int, int, int], int] = {}
    for k, iv in enumerate(ivs.intervals):
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        # signed code rows once per (interval, seq) — every pair reuses them
        rows = {s: _signed_codes_row(iv, genomes, s) for s in present}
        for ai in range(len(present)):
            for bi in range(ai + 1, len(present)):
                i, j = present[ai], present[bi]
                sym_full = SYMBOL_LUT[rows[i], rows[j]]
                key = (k, i, j)
                nz = np.nonzero(sym_full != SYM_NONE)[0]
                full_len[key] = len(sym_full)
                compact_idx[key] = nz
                sym_c = sym_full[nz]
                T_c = len(sym_c)
                if T_c == 0:
                    continue
                if T_c <= max_cols:
                    jobs.append((key, 0, sym_c))
                else:
                    # chunk with overlap; posteriors stitched mid-overlap
                    step = max_cols - overlap
                    for a in range(0, T_c, step):
                        b = min(a + max_cols, T_c)
                        jobs.append((key, a, sym_c[a:b]))
                        if b == T_c:
                            break
    timing.GLOBAL.add("bb_symbols_s", time.perf_counter() - t0)
    out: Dict[Tuple[int, int, int], np.ndarray] = {}
    if not jobs:
        return out
    t0 = time.perf_counter()
    decoded = hmm_ops.bucketed_decode(
        [sym for (_, _, sym) in jobs],
        params.log_trans(),
        np.log([0.5, 0.5]),
        mode="posterior0" if threshold is None else "threshold0",
        threshold=0.5 if threshold is None else threshold,
        max_cols=max_cols,
        emit_table=params.log_emit_table(),  # [2, 4]; lookup runs on device
        device=device,
    )
    timing.GLOBAL.add("bb_decode_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    compact_out: Dict[Tuple[int, int, int], np.ndarray] = {}
    for (key, a, sym), p in zip(jobs, decoded):
        if key not in compact_out:
            compact_out[key] = np.zeros(
                len(compact_idx[key]), bool if threshold is not None else np.float64
            )
        if a == 0:
            compact_out[key][a : a + len(sym)] = p
        else:
            # skip the first half-overlap (burn-in) when stitching
            skip = overlap // 2
            compact_out[key][a + skip : a + len(sym)] = p[skip:]
    for key, pc in compact_out.items():
        nz = compact_idx[key]
        T_full = full_len[key]
        if len(nz) == T_full:
            out[key] = pc
        else:
            # forward-fill from the nearest decoded column at/before each
            # position (clamped to the first decoded column at the start)
            carry = np.maximum(
                np.searchsorted(nz, np.arange(T_full), side="right") - 1, 0
            )
            out[key] = pc[carry]
    timing.GLOBAL.add("bb_stitch_s", time.perf_counter() - t0)
    return out


def pairwise_homology_bits(
    ivs: IntervalList,
    params: HmmParams,
    threshold: float = 0.5,
    max_cols: int = 1 << 16,
    overlap: int = 2048,
    device="cuda",
) -> Dict[Tuple[int, int, int], np.ndarray]:
    """Device-resident replacement for the detect_backbone consumer of
    pairwise_homology_posteriors: thresholded P(Homologous) per column for
    every (interval, i, j) projection, as bool arrays.

    The host path extracts a SYMBOL stream per PAIR (n^2/2 uploads per
    interval, host LUT + both-gap compaction + posterior stitch-back);
    here one uint8 code ROW per present (interval, seq) uploads once, and
    pair symbol classes, emission lookup, both-gap inert handling
    (identity chain elements — the projected-pair semantics), decode and
    thresholding all run on `device` (ops/hmm.pair_rows_state0_gt); the
    bools come back in one transfer per chunk.  Reference analog: detectAndApplyBackbone
    scoring the pairwise projections, src/progressiveMauve.cpp:226-260.

    Chunking above max_cols stitches mid-overlap like the host path; the
    overlap is wider (2048 vs 512) because inert both-gap columns consume
    burn-in without advancing the projected chain.
    """
    genomes = ivs.genomes
    from mauvealigner_tpu_torch.utils import timing

    t0 = time.perf_counter()
    row_blobs: List[np.ndarray] = []   # uint8 row slices, global ids
    jobs = []   # (key, col_start, global_i, global_j, width)
    out: Dict[Tuple[int, int, int], np.ndarray] = {}
    for k, iv in enumerate(ivs.intervals):
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        if len(present) < 2:
            continue
        rows = {
            s: _signed_codes_row(iv, genomes, s).view(np.uint8) for s in present
        }
        T_full = iv.n_cols
        if T_full <= max_cols:
            chunks = [(0, T_full)]
        else:
            step = max_cols - overlap
            chunks = []
            for a in range(0, T_full, step):
                b = min(a + max_cols, T_full)
                chunks.append((a, b))
                if b == T_full:
                    break
        for (a, b) in chunks:
            gidx = {}
            for s in present:
                gidx[s] = len(row_blobs)
                row_blobs.append(rows[s][a:b])
            for ai in range(len(present)):
                for bi in range(ai + 1, len(present)):
                    i, j = present[ai], present[bi]
                    key = (k, i, j)
                    if key not in out:
                        out[key] = np.zeros(T_full, bool)
                    jobs.append((key, a, gidx[i], gidx[j], b - a))
    timing.GLOBAL.add("bb_symbols_s", time.perf_counter() - t0)
    if not jobs:
        return out
    t0 = time.perf_counter()
    from mauvealigner_tpu_torch.parallel import context as par_ctx

    # f64 transition chain over f32 emissions: the promotion the JAX
    # package gets under global x64
    lt = torch.as_tensor(params.log_trans(), dtype=torch.float64, device=device)
    li = torch.as_tensor(np.log([0.5, 0.5]), dtype=torch.float64, device=device)
    tab = torch.as_tensor(
        np.ascontiguousarray(params.log_emit_table().astype(np.float32).T), device=device
    )  # [4, 2]
    buckets: Dict[int, List[int]] = {}
    for idx, (_, _, _, _, width) in enumerate(jobs):
        # the scan's tree (and so its rounding) depends on the padded width:
        # the JAX package's power-of-two buckets
        Tp = 1 << max(4, (width - 1).bit_length())
        buckets.setdefault(Tp, []).append(idx)
    for Tp, idxs in buckets.items():
        cap_pairs = max(8, (1 << 27) // (Tp * 16))
        for off in range(0, len(idxs), cap_pairs):
            chunk = [jobs[i] for i in idxs[off : off + cap_pairs]]
            uniq = sorted({g for (_, _, gi, gj, _) in chunk for g in (gi, gj)})
            loc = {g: n for n, g in enumerate(uniq)}
            rows_arr = np.full((len(uniq), Tp), 5, np.uint8)
            for g, n in loc.items():
                blob = row_blobs[g]
                rows_arr[n, : len(blob)] = blob
            ii = np.zeros(len(chunk), np.int64)
            jj = np.zeros(len(chunk), np.int64)
            lens = np.zeros(len(chunk), np.int64)
            for n, (_, _, gi, gj, width) in enumerate(chunk):
                ii[n], jj[n], lens[n] = loc[gi], loc[gj], width
            # batch-sharded under an ambient mesh (per-element decode,
            # bit-identical to the direct call)
            bits = par_ctx.shard_batched_call(
                lambda i2, j2, ln, rws, tb, t, ini, device: hmm_ops.pair_rows_state0_gt(
                    rws, i2, j2, tb, t, ini, ln, float(threshold)
                ),
                [torch.from_numpy(ii), torch.from_numpy(jj), torch.from_numpy(lens)],
                (torch.from_numpy(rows_arr), tab, lt, li), device=device,
            )
            for n, (key, a, _, _, width) in enumerate(chunk):
                got = bits[n, :width]
                if a == 0:
                    out[key][a : a + width] = got
                else:
                    skip = overlap // 2
                    out[key][a + skip : a + width] = got[skip:]
    timing.GLOBAL.add("bb_decode_s", time.perf_counter() - t0)
    return out


@dataclasses.dataclass
class BackboneColumnSegment:
    interval_index: int
    col_start: int
    col_end: int                 # half-open
    seqs: List[int]              # sequences homologous over this range


def detect_backbone(
    ivs: IntervalList,
    params: HmmParams,
    island_gap_size: int = 20,
    posterior_threshold: float = 0.5,
    device_symbols: bool = True,
    device="cuda",
) -> List[BackboneColumnSegment]:
    """detectBackbone + BigGapsDetector equivalents
    (src/progressiveMauve.cpp:242-243): per sequence per column, homologous
    iff some partner's pair-HMM posterior exceeds the threshold; gap runs
    longer than island_gap_size are never backbone.

    device_symbols routes the posterior pass through the device-resident
    row path (pairwise_homology_bits, the default); False takes the host
    symbol path, which remains the cross-validation reference.  Both decode
    on `device`."""
    if device_symbols:
        posts = pairwise_homology_bits(
            ivs, params, threshold=posterior_threshold, device=device
        )
    else:
        posts = pairwise_homology_posteriors(
            ivs, params, threshold=posterior_threshold, device=device
        )
    from mauvealigner_tpu_torch.utils import timing

    _t0 = time.perf_counter()
    segments: List[BackboneColumnSegment] = []
    for k, iv in enumerate(ivs.intervals):
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        if not present:
            continue
        hom = np.zeros((iv.n_seqs, iv.n_cols), bool)
        for (kk, i, j), good in posts.items():
            if kk != k:
                continue
            hom[i] |= good & iv.aln[i]
            hom[j] |= good & iv.aln[j]
        # BigGapsDetector: long gap runs are not backbone for that sequence
        for s in present:
            gaps = ~iv.aln[s]
            d = np.diff(np.concatenate([[0], gaps.view(np.int8), [0]]))
            starts = np.nonzero(d == 1)[0]
            ends = np.nonzero(d == -1)[0]
            for a, b in zip(starts, ends):
                if b - a > island_gap_size:
                    hom[s, a:b] = False
        if len(present) == 1:
            continue
        # segment columns by the constant homologous-set signature
        sig = hom[present].T  # [n_cols, n_present]
        if not len(sig):
            continue
        change = np.ones(iv.n_cols, bool)
        change[1:] = np.any(sig[1:] != sig[:-1], axis=1)
        seg_starts = np.nonzero(change)[0]
        seg_ends = np.append(seg_starts[1:], iv.n_cols)
        for a, b in zip(seg_starts, seg_ends):
            seqs = [present[x] for x in range(len(present)) if sig[a, x]]
            if len(seqs) >= 2:
                segments.append(BackboneColumnSegment(k, int(a), int(b), seqs))
    timing.GLOBAL.add("bb_detect_s", time.perf_counter() - _t0)
    return segments


def detect_backbone_big_gaps(
    ivs: IntervalList,
    gap_size: int,
    gene_bounds: Optional[Sequence[np.ndarray]] = None,
) -> List[BackboneColumnSegment]:
    """Gap-structure-only backbone (the bbBreakOnGenes pipeline,
    src/bbBreakOnGenes.cpp:41-225): for every sequence pair, HSS = maximal
    runs of pairwise-projected columns with no gap run > gap_size in either
    member (BigGapsDetector semantics); pairwise predictions merge into
    n-way segments by the constant homologous-set signature.

    gene_bounds[s] (sorted positions p, "cut between genome positions p-1
    and p of sequence s") additionally split segments at the matching
    alignment columns — the applyBreakpoints(gene_bounds) step
    (src/bbBreakOnGenes.cpp:92-103,222).  Deviation: the reference splits
    each *pairwise* HSS before the n-way merge; splitting the merged
    segments at all members' bound columns yields the same cut positions
    because merging never moves a pairwise cut."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    segments: List[BackboneColumnSegment] = []
    for k, iv in enumerate(ivs.intervals):
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        if len(present) < 2:
            continue
        hom = np.zeros((iv.n_seqs, iv.n_cols), bool)
        for a in range(len(present)):
            for b in range(a + 1, len(present)):
                i, j = present[a], present[b]
                proj_cols = np.nonzero(iv.aln[i] | iv.aln[j])[0]
                if not len(proj_cols):
                    continue
                big = np.zeros(len(proj_cols), bool)
                for s in (i, j):
                    gaps = ~iv.aln[s, proj_cols]
                    d = np.diff(np.concatenate([[0], gaps.view(np.int8), [0]]))
                    for ga, gb in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
                        if gb - ga > gap_size:
                            big[ga:gb] = True
                keep = proj_cols[~big]
                hom[i, keep] = True
                hom[j, keep] = True
        # per-interval cut columns from gene boundaries of every member
        cuts: set = set()
        if gene_bounds is not None:
            for s in present:
                bounds = gene_bounds[s]
                if bounds is None or not len(bounds):
                    continue
                pos = np.abs(_interval_positions(iv, s))
                pcols = np.nonzero(pos)[0]
                if not len(pcols):
                    continue
                pvals = pos[pcols]
                if iv.starts[s] > 0:
                    # ascending positions: cut before first col with pos >= p
                    idx = np.searchsorted(pvals, bounds, side="left")
                    ok = (idx > 0) & (idx < len(pcols))
                    cuts.update(int(c) for c in pcols[idx[ok]])
                else:
                    # descending: cols with pos < p are the last (count) ones
                    rv = pvals[::-1]
                    cnt = np.searchsorted(rv, bounds, side="left")
                    ok = (cnt > 0) & (cnt < len(pcols))
                    cuts.update(int(c) for c in pcols[len(pcols) - cnt[ok]])
        cut_list = sorted(cuts)
        # segment columns by the constant homologous-set signature
        sig = hom[present].T
        change = np.ones(iv.n_cols, bool)
        change[1:] = np.any(sig[1:] != sig[:-1], axis=1)
        for c in cut_list:
            change[c] = True
        seg_starts = np.nonzero(change)[0]
        seg_ends = np.append(seg_starts[1:], iv.n_cols)
        for a, b in zip(seg_starts, seg_ends):
            seqs = [present[x] for x in range(len(present)) if sig[a, x]]
            if len(seqs) >= 2:
                segments.append(BackboneColumnSegment(k, int(a), int(b), seqs))
    return segments


def _segment_arrays(
    segments: List[BackboneColumnSegment], n_seqs: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(iv_idx[S], col_start[S], col_end[S], member[S, n_seqs]) bulk arrays."""
    S = len(segments)
    iv_idx = np.fromiter(
        (s.interval_index for s in segments), np.int64, count=S
    )
    a = np.fromiter((s.col_start for s in segments), np.int64, count=S)
    b = np.fromiter((s.col_end for s in segments), np.int64, count=S)
    member = np.zeros((S, n_seqs), bool)
    counts = np.fromiter((len(s.seqs) for s in segments), np.int64, count=S)
    total = int(counts.sum())
    if total:
        from itertools import chain

        flat_rows = np.repeat(np.arange(S), counts)
        flat_cols = np.fromiter(
            chain.from_iterable(s.seqs for s in segments),
            np.int64,
            count=total,
        )
        member[flat_rows, flat_cols] = True
    return iv_idx, a, b, member


def _merge_adjacent_arrays(
    iv_idx: np.ndarray, a: np.ndarray, b: np.ndarray, member: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Array core of merge_adjacent_segments: returns the merged
    (iv_idx, col_start, col_end, member) sorted by (interval, col_start).

    A chain merge only ever extends the growing segment's col_end to the
    newest member's, so whether sorted segment i joins segment i-1's chain
    depends only on the ORIGINAL i-1 and i — the pass vectorizes as a
    pairwise joinability test + grouped first/last gather (the per-segment
    python loop was part of the 17 s bb_apply floor at 830k headline rows).
    """
    order = np.lexsort((a, iv_idx))
    iv_s, a_s, b_s, mem_s = iv_idx[order], a[order], b[order], member[order]
    joinable = np.zeros(len(order), bool)
    if len(order) > 1:
        joinable[1:] = (
            (iv_s[1:] == iv_s[:-1])
            & (a_s[1:] == b_s[:-1])
            & (mem_s[1:] == mem_s[:-1]).all(axis=1)
        )
    firsts = np.nonzero(~joinable)[0]
    lasts = np.append(firsts[1:] - 1, len(order) - 1)
    return (
        iv_s[firsts], a_s[firsts], b_s[lasts], mem_s[firsts], order[firsts]
    )


def merge_adjacent_segments(
    segments: List[BackboneColumnSegment], n_seqs: Optional[int] = None
) -> List[BackboneColumnSegment]:
    """Merge column-adjacent segments with the same sequence set
    (mergeAdjacentSegments equivalent)."""
    if not segments:
        return []
    if n_seqs is None:
        n_seqs = 1 + max((max(s.seqs) if s.seqs else 0) for s in segments)
    iv2, a2, b2, _, first_orig = _merge_adjacent_arrays(
        *_segment_arrays(segments, n_seqs)
    )
    return [
        BackboneColumnSegment(int(k), int(x), int(y), segments[f].seqs)
        for k, x, y, f in zip(
            iv2.tolist(), a2.tolist(), b2.tolist(), first_orig.tolist()
        )
    ]


def merge_coordinate_rows(rows: List[np.ndarray]) -> List[np.ndarray]:
    """Merge coordinate rows that are exactly adjacent in every member
    sequence with the same membership (mergeAdjacentSegments over
    bb_seqentry_t rows).

    Chain merges only ever replace the growing row's RIGHT ends with the
    newest row's, so whether sorted row i joins row i-1's chain depends only
    on the ORIGINAL rows i and i-1 — the whole pass vectorizes as a pairwise
    joinability test + grouped first/last gather.

    Accepts a [R, 2n] matrix OR a list of rows and returns the same kind
    (np.stack over ~580k row views cost 1.2 s at headline scale — the
    progressive pipeline keeps the matrix form end-to-end)."""
    as_matrix = isinstance(rows, np.ndarray)
    if len(rows) == 0:
        return rows
    R = (
        rows.astype(np.int64, copy=False)
        if as_matrix
        else np.stack(rows).astype(np.int64, copy=False)
    )
    n2 = R.shape[1]
    absent = R[:, ::2] == 0
    key2 = np.abs(R[:, 2]) if n2 > 2 else np.zeros(len(R), np.int64)
    # np.lexsort: last key is primary; mirror the reference tuple key
    # (membership bools, |left of seq0|, |left of seq1|)
    keys = [key2, np.abs(R[:, 0])] + [absent[:, s] for s in range(absent.shape[1] - 1, -1, -1)]
    order = np.lexsort(keys)
    S = R[order]
    mem = ~absent[order]
    if len(S) == 1:
        return S.copy() if as_matrix else [S[0].copy()]
    A, P = S[1:], S[:-1]
    same_mem = (mem[1:] == mem[:-1]).all(axis=1)
    al, pl, pr = A[:, ::2], P[:, ::2], P[:, 1::2]
    ok = (~mem[1:]) | ((np.abs(al) == np.abs(pr) + 1) & (np.sign(al) == np.sign(pl)))
    joinable = same_mem & ok.all(axis=1)
    newgrp = np.empty(len(S), bool)
    newgrp[0] = True
    newgrp[1:] = ~joinable
    firsts = np.nonzero(newgrp)[0]
    lasts = np.append(firsts[1:] - 1, len(S) - 1)
    out = S[firsts].copy()
    out[:, 1::2] = S[lasts][:, 1::2]
    return out if as_matrix else list(out)


def _segment_seq_coordinates(
    ivs: IntervalList,
    segments: List[BackboneColumnSegment],
    pos_cache: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
) -> np.ndarray:
    """Signed per-seq [left, right] coordinate pairs for every segment, as a
    (n_segments, 2*n_seqs) int64 matrix (row order = segment order).

    Vectorized over segments: within one interval a present row's nonzero
    positions are strand-monotone (interval tiling invariant), so the min/max
    |position| over a column range are at the first/last nonzero column —
    O(1) lookups from cumulative first/last-nonzero scans per (interval, seq).
    """
    return _segment_seq_coordinates_arrays(
        ivs, *_segment_arrays(segments, ivs.n_seqs)
    )


def _segment_seq_coordinates_arrays(
    ivs: IntervalList,
    iv_idx: np.ndarray,
    a_all: np.ndarray,
    b_all: np.ndarray,
    member_all: np.ndarray,
) -> np.ndarray:
    n = ivs.n_seqs
    coords = np.zeros((len(iv_idx), 2 * n), np.int64)
    for k in np.unique(iv_idx):
        iv = ivs.intervals[int(k)]
        sidx = np.nonzero(iv_idx == k)[0]
        n_cols = iv.n_cols
        a = a_all[sidx]
        b1 = b_all[sidx] - 1
        member = member_all[sidx]
        arange = np.arange(n_cols, dtype=np.int32)
        for s in range(n):
            sel = member[:, s]
            if not sel.any() or int(iv.starts[s]) == 0:
                continue
            row = iv.aln[s]
            rank = np.cumsum(row, dtype=np.int32)  # base count per column
            length = int(rank[-1])
            if length == 0:
                continue
            nz = row
            left = abs(int(iv.starts[s]))
            fwd = int(iv.starts[s]) > 0
            last_nz = np.maximum.accumulate(np.where(nz, arange, np.int32(-1)))
            first_nz = np.minimum.accumulate(np.where(nz, arange, np.int32(n_cols))[::-1])[::-1]
            # python slicing clamps out-of-range column windows; mirror that
            aa = np.clip(a[sel], 0, n_cols - 1)
            bb = np.clip(b1[sel], 0, n_cols - 1)
            f = first_nz[aa]
            valid = (a[sel] < n_cols) & (b1[sel] >= 0) & (f <= bb)
            fc = np.where(valid, f, 0)
            lc = np.where(valid, last_nz[bb], 0)
            # signed position at a present column c: forward strand
            # left+rank[c]-1, reverse -(left+length-rank[c]) — |pos| is
            # monotone over present columns, so lo/hi come from fc/lc
            # (fc <= lc, so |pos[fc]| <= |pos[lc]| forward and the reverse
            # strand flips the extremes)
            rf = rank[fc].astype(np.int64)
            rl = rank[lc].astype(np.int64)
            rows = sidx[sel]
            if fwd:
                lo = left + rf - 1
                hi = left + rl - 1
            else:
                lo = -(left + length - rl)
                hi = -(left + length - rf)
            coords[rows, 2 * s] = np.where(valid, lo, 0)
            coords[rows, 2 * s + 1] = np.where(valid, hi, 0)
    return coords


def backbone_seq_coordinates(
    ivs: IntervalList,
    segments: List[BackboneColumnSegment],
    as_matrix: bool = False,
) -> List[np.ndarray]:
    """Per segment: signed per-seq [left, right] coordinate pairs
    (writeBackboneSeqCoordinates equivalent).  as_matrix=True returns the
    [n_segments, 2*n_seqs] matrix itself (the fast bulk form the
    progressive pipeline threads through merge/add_unique/write)."""
    coords = _segment_seq_coordinates(ivs, segments)
    return coords if as_matrix else list(coords)


def add_unique_segments(
    rows: List[np.ndarray], ivs: IntervalList, seq_lengths: Sequence[int]
) -> List[np.ndarray]:
    """Append per-genome segments covered by no backbone row
    (addUniqueSegments equivalent): regions unique to one genome.

    Coverage fills with a range-difference array per genome — the
    per-row python slice loop was ~7M iterations at the headline scale."""
    n = ivs.n_seqs
    as_matrix = isinstance(rows, np.ndarray)
    if as_matrix:
        R = np.abs(rows.astype(np.int64, copy=False)) if len(rows) else None
    else:
        R = np.abs(np.stack(rows).astype(np.int64)) if rows else None
    out = None if as_matrix else list(rows)
    runs = []  # (seq, starts[], ends[]) — bulk row build below
    for s in range(n):
        glen = seq_lengths[s]
        if glen == 0:
            continue
        # uncovered runs via an interval-union sweep over the row extents —
        # O(rows log rows) instead of the O(genome) delta/cumsum fill
        # (which allocated + touched ~3 genome-length arrays per seq)
        if R is not None:
            l, rr = R[:, 2 * s], R[:, 2 * s + 1]
            sel = l > 0
            l, rr = l[sel], np.minimum(rr[sel], glen)
        else:
            l = np.zeros(0, np.int64)
        if not len(l):
            runs.append((s, np.array([1], np.int64), np.array([glen], np.int64)))
            continue
        order = np.argsort(l, kind="stable")
        ls, rs = l[order], rr[order]
        cm = np.maximum.accumulate(rs)  # covered through cm[i] after row i
        # free gap before row i+1 when its left starts past the running max
        gs = cm[:-1] + 1
        ge = ls[1:] - 1
        good = ge >= gs
        starts = gs[good]
        ends = ge[good]
        head_s, head_e = (np.int64(1), ls[0] - 1) if ls[0] > 1 else (None, None)
        tail_s, tail_e = (cm[-1] + 1, np.int64(glen)) if cm[-1] < glen else (None, None)
        if head_s is not None:
            starts = np.concatenate([[head_s], starts])
            ends = np.concatenate([[head_e], ends])
        if tail_s is not None:
            starts = np.concatenate([starts, [tail_s]])
            ends = np.concatenate([ends, [tail_e]])
        if len(starts):
            runs.append((s, starts, ends))
    total = sum(len(st) for (_, st, _) in runs)
    M = np.zeros((total, 2 * n), np.int64)
    r0 = 0
    # one bulk matrix instead of ~total tiny row allocations (the
    # per-run loop was ~1.6 s of bb_rows at headline scale)
    for s, starts, ends in runs:
        M[r0 : r0 + len(starts), 2 * s] = starts
        M[r0 : r0 + len(starts), 2 * s + 1] = ends
        r0 += len(starts)
    if as_matrix:
        base = rows if len(rows) else np.zeros((0, 2 * n), np.int64)
        return np.concatenate([base, M]) if total else rows
    if total:
        out.extend(M)
    return out


def write_backbone_seq_file(rows: List[np.ndarray], out: Union[str, TextIO], n_seqs: int) -> None:
    """.backbone TSV (writeBackboneSeqFile format: header + signed coords)."""
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_backbone_seq_file(rows, fh, n_seqs)
            return
    fh = out
    fh.write("\t".join(f"seq{i}_leftend\tseq{i}_rightend" for i in range(n_seqs)) + "\n")
    if len(rows) == 0:
        return
    M = rows if isinstance(rows, np.ndarray) else np.stack(rows)
    # bulk tolist + join: ~5x the per-row generator at headline row counts
    fh.write("\n".join("\t".join(map(str, r)) for r in M.tolist()))
    fh.write("\n")


def read_backbone_seq_file(src: Union[str, TextIO]) -> List[np.ndarray]:
    if isinstance(src, str):
        with open(src) as fh:
            return read_backbone_seq_file(fh)
    rows = []
    for line in src:
        line = line.strip()
        if not line or line.startswith("seq0"):
            continue
        rows.append(np.array([int(x) for x in line.split("\t")], np.int64))
    return rows


def write_backbone_cols_file(
    segments: List[BackboneColumnSegment], out: Union[str, TextIO]
) -> None:
    """.bbcols: per line `interval col_start col_end seq seq ...` — all
    whitespace-separated tokens, the format the reference's bbcols reader
    consumes (src/stripSubsetLCBs.cpp:78-104)."""
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_backbone_cols_file(segments, fh)
            return
    for seg in segments:
        out.write(
            f"{seg.interval_index}\t{seg.col_start}\t{seg.col_end}\t"
            + "\t".join(str(s) for s in seg.seqs)
            + "\n"
        )


def read_backbone_cols_file(src: Union[str, TextIO]) -> List[BackboneColumnSegment]:
    if isinstance(src, str):
        with open(src) as fh:
            return read_backbone_cols_file(fh)
    out = []
    for line in src:
        toks = line.replace(",", " ").split()
        if not toks:
            continue
        out.append(
            BackboneColumnSegment(
                int(toks[0]), int(toks[1]), int(toks[2]),
                [int(x) for x in toks[3:]],
            )
        )
    return out


def _segments_from_member_arrays(
    iv_idx: np.ndarray, a: np.ndarray, b: np.ndarray, member: np.ndarray
) -> List[BackboneColumnSegment]:
    return [
        BackboneColumnSegment(
            int(k), int(x), int(y), np.nonzero(m)[0].tolist()
        )
        for k, x, y, m in zip(iv_idx.tolist(), a.tolist(), b.tolist(), member)
    ]


def _apply_backbone_interval_loop(
    iv: Interval,
    merged: List[BackboneColumnSegment],
    sidx: List[int],
    coords: np.ndarray,
    new_intervals: List[Interval],
) -> None:
    """Per-segment loop path for one interval — handles OVERLAPPING segment
    column ranges (possible only for externally supplied .bbcols input; the
    detector's segments tile disjoint ranges).  Kept as the semantic
    reference for the vectorized bulk path below."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    pos = {
        s: _interval_positions(iv, s)
        for s in range(iv.n_seqs)
        if iv.starts[s] != 0
    }
    # consumed[s] = union of segment column ranges where s is a valid
    # member (coords nonzero <=> the reference's nz.any() gate)
    delta = {s: np.zeros(iv.n_cols + 1, np.int32) for s in pos}
    for i in sidx:
        seg = merged[i]
        for s in seg.seqs:
            if coords[i, 2 * s] != 0:
                delta[s][seg.col_start] += 1
                delta[s][seg.col_end] -= 1
    consumed = {s: np.cumsum(d[:-1]) > 0 for s, d in delta.items()}
    for i in sidx:
        seg = merged[i]
        starts = coords[i, ::2].copy()
        member_valid = starts != 0
        if not member_valid.any():
            continue
        aln = iv.aln[:, seg.col_start : seg.col_end] & member_valid[:, None]
        keep = aln.any(axis=0)
        if keep.all():
            new_intervals.append(Interval(starts, aln))
        elif keep.any():
            new_intervals.append(Interval(starts, aln[:, keep]))
    # leftover bases per sequence -> unaligned single-seq intervals
    for s in pos:
        rest = iv.aln[s] & ~consumed[s]
        if not rest.any():
            continue
        p = pos[s][rest]
        p = p[p != 0]
        if not len(p):
            continue
        absp = np.sort(np.abs(p))
        # contiguous runs of positions
        breaks = np.nonzero(np.diff(absp) != 1)[0]
        run_starts = np.concatenate([[0], breaks + 1])
        run_ends = np.concatenate([breaks, [len(absp) - 1]])
        for a, b in zip(run_starts, run_ends):
            st = np.zeros(iv.n_seqs, np.int64)
            st[s] = int(absp[a])
            aln1 = np.zeros((iv.n_seqs, int(absp[b] - absp[a] + 1)), bool)
            aln1[s] = True
            new_intervals.append(Interval(st, aln1))


def _apply_backbone_interval_bulk(
    iv: Interval,
    a_arr: np.ndarray,
    b_arr: np.ndarray,
    starts_mat: np.ndarray,
    new_intervals: List[Interval],
) -> None:
    """Vectorized apply for one interval whose (column-sorted) segments are
    DISJOINT: one bulk member mask + one fancy-index copy replace the
    per-segment python slicing (bb_apply was 17 s of the round-4 headline).
    Byte-identical to _apply_backbone_interval_loop (pinned by
    tests/test_analysis.py::test_apply_backbone_bulk_equivalence)."""
    n, T = iv.aln.shape
    S = len(a_arr)
    valid = starts_mat != 0  # [S, n]
    any_valid = valid.any(axis=1)
    # per-column membership mask (disjoint ranges: one segment per column)
    seg_f, seq_f = np.nonzero(valid)
    d = np.zeros((n, T + 1), np.int8)
    np.add.at(d, (seq_f, a_arr[seg_f]), 1)
    np.add.at(d, (seq_f, b_arr[seg_f]), -1)
    # 1-D int8 cumsum: every row nets to zero (disjoint ranges close within
    # the row), so the running value stays in {0, 1} across rows; the 2-D
    # int64 cumsum allocated 8x the memory and page-faulted ~1 s/interval
    mask = (
        np.cumsum(d.ravel(), dtype=np.int8)
        .reshape(n, T + 1)[:, :-1]
        .astype(bool)
    )  # == consumed[s]
    aln_masked = iv.aln & mask
    keep_col = aln_masked.any(axis=0)
    keep_cols = np.nonzero(keep_col)[0]
    # kept-column count per segment via searchsorted over the kept indices
    o0 = np.searchsorted(keep_cols, a_arr)
    o1 = np.searchsorted(keep_cols, b_arr)
    A = np.ascontiguousarray(aln_masked[:, keep_cols])
    # zero-width segments emit like the loop path (empty keep -> all())
    emit = np.nonzero(any_valid & ((o1 > o0) | (b_arr == a_arr)))[0]
    starts_rows = np.ascontiguousarray(starts_mat[emit])
    oo0, oo1 = o0[emit].tolist(), o1[emit].tolist()
    mk = Interval._unchecked
    append = new_intervals.append
    for i in range(len(emit)):
        append(mk(starts_rows[i], A[:, oo0[i] : oo1[i]]))
    # leftover bases per sequence -> unaligned single-seq intervals
    for s in range(n):
        st_s = int(iv.starts[s])
        if st_s == 0:
            continue
        rest = iv.aln[s] & ~mask[s]
        if not rest.any():
            continue
        # |positions| of the leftover bases, ascending: forward strand maps
        # columns to ascending positions, reverse to descending
        row = iv.aln[s]
        rank = np.cumsum(row, dtype=np.int32)
        length = int(rank[-1])
        left = abs(st_s)
        r = rank[rest].astype(np.int64)
        absp = (left + r - 1) if st_s > 0 else (left + length - r)[::-1]
        breaks = np.nonzero(np.diff(absp) != 1)[0]
        run_starts = np.concatenate([[0], breaks + 1])
        run_ends = np.concatenate([breaks, [len(absp) - 1]])
        # bulk buffers for the single-seq leftovers: starts as matrix rows,
        # aln as slices of one all-True row embedded in an all-False block
        widths = (absp[run_ends] - absp[run_starts] + 1).astype(np.int64)
        n_runs = len(run_starts)
        st_mat = np.zeros((n_runs, n), np.int64)
        st_mat[:, s] = absp[run_starts]
        wmax = int(widths.max())
        block = np.zeros((n, wmax), bool)
        block[s] = True
        mk = Interval._unchecked
        append = new_intervals.append
        for i, w in enumerate(widths.tolist()):
            append(mk(st_mat[i], block[:, :w]))


def apply_backbone(
    ivs: IntervalList,
    segments: List[BackboneColumnSegment],
    raw_coords: Optional[np.ndarray] = None,
) -> IntervalList:
    """detectAndApplyBackbone's 'apply' step: split intervals at backbone
    boundaries so every emitted interval has a constant homologous sequence
    set; bases outside any backbone segment become unaligned single-seq
    intervals.

    raw_coords: the backbone_seq_coordinates(ivs, segments, as_matrix=True)
    matrix when the caller already computed it (the progressive pipeline
    does, for the .backbone rows) — the merged segments' coordinates then
    come from a grouped |coord| min/max reduction instead of a second full
    column scan of every interval (segments tile disjoint ranges, so a
    merged group's extreme positions are the extremes of its members')."""
    from mauvealigner_tpu_torch.utils import timing

    _t0 = time.perf_counter()
    if segments:
        iv_r, a_r, b_r, mem_r = _segment_arrays(segments, ivs.n_seqs)
        order = np.lexsort((a_r, iv_r))
        iv_s, a_s, b_s = iv_r[order], a_r[order], b_r[order]
        mem_s = mem_r[order]
        joinable = np.zeros(len(order), bool)
        if len(order) > 1:
            joinable[1:] = (
                (iv_s[1:] == iv_s[:-1])
                & (a_s[1:] == b_s[:-1])
                & (mem_s[1:] == mem_s[:-1]).all(axis=1)
            )
        firsts = np.nonzero(~joinable)[0]
        lasts = np.append(firsts[1:] - 1, len(order) - 1)
        iv2, a2, b2 = iv_s[firsts], a_s[firsts], b_s[lasts]
        mem2 = mem_s[firsts]
    else:
        iv2 = a2 = b2 = np.zeros(0, np.int64)
        mem2 = np.zeros((0, ivs.n_seqs), bool)
    if (
        raw_coords is not None
        and len(segments)
        and len(raw_coords) == len(segments)
    ):
        cs = raw_coords[order]
        lo_abs = np.abs(cs[:, ::2])
        hi_abs = np.abs(cs[:, 1::2])
        sentinel = np.int64(1) << 62
        lo_abs = np.where(lo_abs == 0, sentinel, lo_abs)
        lo_min = np.minimum.reduceat(lo_abs, firsts, axis=0)
        hi_max = np.maximum.reduceat(hi_abs, firsts, axis=0)
        sign = np.sign(np.add.reduceat(np.sign(cs[:, ::2]), firsts, axis=0))
        coords = np.zeros((len(firsts), 2 * ivs.n_seqs), np.int64)
        present = lo_min != sentinel
        coords[:, ::2] = np.where(present, sign * lo_min, 0)
        coords[:, 1::2] = np.where(present, sign * hi_max, 0)
    else:
        coords = _segment_seq_coordinates_arrays(ivs, iv2, a2, b2, mem2)
    # merged output is sorted by (interval, col_start): contiguous runs
    bounds = np.searchsorted(iv2, np.arange(len(ivs.intervals) + 1))
    new_intervals: List[Interval] = []
    for k, iv in enumerate(ivs.intervals):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        if lo == hi:
            new_intervals.append(iv)
            continue
        a_arr, b_arr = a2[lo:hi], b2[lo:hi]
        if hi - lo > 1 and (b_arr[:-1] > a_arr[1:]).any():
            # overlapping column ranges (external .bbcols only): loop path
            merged_k = _segments_from_member_arrays(
                iv2[lo:hi], a_arr, b_arr, mem2[lo:hi]
            )
            _apply_backbone_interval_loop(
                iv, merged_k, list(range(hi - lo)), coords[lo:hi], new_intervals
            )
        else:
            _apply_backbone_interval_bulk(
                iv, a_arr, b_arr, coords[lo:hi][:, ::2], new_intervals
            )
    timing.GLOBAL.add("bb_apply_s", time.perf_counter() - _t0)
    return IntervalList(
        genomes=ivs.genomes,
        intervals=new_intervals,
        seq_filenames=list(ivs.seq_filenames),
        backbone_filename=ivs.backbone_filename,
    )
