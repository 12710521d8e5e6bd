"""True progressive anchoring up the guide tree (consensus-ladder design).

The reference ProgressiveAligner aligns ancestral profiles node by node with
a recursive anchor search per node (src/progressiveMauve.cpp:575-710); the
extant-only full-multiplicity anchoring this replaces collapses at high
divergence (a weight-w seed must survive in EVERY genome simultaneously).

Design: post-order over the guide tree, each node holds
  * a consensus REPRESENTATIVE sequence for its clade (majority base per
    alignment column — the profile stand-in that keeps K1/K2 on plain
    2-bit code arrays and the pairwise code DP unchanged), and
  * per-member signed COLUMN MAPS rep-position -> genome position
    (0 = gap; negative = reverse strand, composing through inversions).

At an internal node the two children's representatives are aligned with the
full single-pair pipeline (device anchoring, LCBs with breakpoint
elimination — rearrangements handled at every level — recursion, gapped
closure), unaligned regions are carried along as single-child columns (so
clade-specific content can still anchor at higher nodes: the
translated-anchor semantic), and member maps compose through the node's
column structure.  The root's columns expand to the final n-way
IntervalList, split wherever any genome's positions break contiguity
(descendant-level rearrangements).

A clade consensus is closer to the ancestral sequence than any extant
member, so per-node pairwise seeds survive divergence that defeats
full-multiplicity extant seeds — the same sensitivity amplifier the
reference gets from profile anchoring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions
from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import CODE_N, Genome
from mauvealigner_tpu_torch.models.lcb import LCB


class NodeProfile:
    """A clade's consensus representative + signed member column maps.

    counts: uint8 [len(rep), 5] per-column base counts over the clade
    members (lane 4 = ambiguous bases; absent members contribute nothing)
    — the TRUE column profile the profile-aware node-merge DP scores
    against, where the rep codes only carry the majority."""

    __slots__ = ("members", "rep", "colmaps", "counts")

    def __init__(self, members, rep, colmaps, counts=None):
        self.members: List[int] = members
        self.rep: Genome = rep
        self.colmaps: Dict[int, np.ndarray] = colmaps  # int64 [len(rep)]
        self.counts: Optional[np.ndarray] = counts


def leaf_profile(index: int, genome: Genome) -> NodeProfile:
    colmap = np.arange(1, len(genome) + 1, dtype=np.int64)
    codes = np.minimum(genome.codes, 4).astype(np.int64)
    counts = np.zeros((len(genome), 5), np.uint8)
    counts[np.arange(len(genome)), codes] = 1
    return NodeProfile([index], genome, {index: colmap}, counts)


def _member_bases(
    genomes: Sequence[Genome], colmap: np.ndarray, member: int
) -> np.ndarray:
    """Base codes of one member along rep columns (4 = gap/N)."""
    out = np.full(len(colmap), CODE_N, np.uint8)
    nz = colmap != 0
    idx = np.abs(colmap[nz]) - 1
    b = genomes[member].codes[idx].astype(np.uint8)
    rev = colmap[nz] < 0
    acgt = b < CODE_N
    flip = rev & acgt
    b = np.where(flip, 3 - b, b)
    out[nz] = b
    return out


def consensus_codes(
    genomes: Sequence[Genome], prof: NodeProfile, with_counts: bool = False
):
    """Majority base per rep column over the clade members (ties resolved
    toward the lowest code — deterministic); columns where no member has an
    unambiguous base become N.

    with_counts=True also returns the uint8 [L, 5] column count profile
    (lanes 0-3 = A/C/G/T votes, lane 4 = ambiguous bases; clipped at 255)."""
    L = len(prof.colmaps[prof.members[0]])
    votes = np.zeros((4, L), np.int32)
    n_amb = np.zeros(L, np.int32)
    for m in prof.members:
        b = _member_bases(genomes, prof.colmaps[m], m)
        ok = b < 4
        for c in range(4):
            votes[c] += (b == c) & ok
        if with_counts:
            n_amb += (b == CODE_N) & (prof.colmaps[m] != 0)
    best = votes.argmax(axis=0).astype(np.uint8)
    none = votes.sum(axis=0) == 0
    best[none] = CODE_N
    if not with_counts:
        return best
    counts = np.concatenate([votes.T, n_amb[:, None]], axis=1)
    return best, np.minimum(counts, 255).astype(np.uint8)


def _node_alignment_columns(ivl: IntervalList) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate every interval's per-row signed positions: two int64
    arrays [n_cols_total] for (row 0, row 1)."""
    pa, pb = [], []
    for iv in ivl.intervals:
        pa.append(_interval_positions(iv, 0))
        pb.append(_interval_positions(iv, 1))
    if not pa:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(pa), np.concatenate(pb)


def _compose(colmap: np.ndarray, node_pos: np.ndarray) -> np.ndarray:
    """Compose a child colmap through the node's signed child-rep positions:
    out[c] = sign(node_pos[c]) * colmap[|node_pos[c]|-1] (0 stays 0)."""
    out = np.zeros(len(node_pos), np.int64)
    nz = node_pos != 0
    idx = np.abs(node_pos[nz]) - 1
    vals = colmap[idx]
    neg = node_pos[nz] < 0
    np.negative(vals, where=neg, out=vals)
    out[nz] = vals
    return out


def _compose_counts(counts: np.ndarray, node_pos: np.ndarray) -> np.ndarray:
    """Gather a child's [L, 5] column counts through the node's signed
    child-rep positions (reverse-strand columns complement the base lanes).
    Counts are ADDITIVE over members, so a merged node's profile is the sum
    of its two children's composed counts — one gather + add instead of
    re-deriving votes from every member (the per-member loop was 12 s of
    the 4.6 Mbp headline).

    Output stays uint8: per-column counts are bounded by the clade member
    count and seq ids are < 128 pipeline-wide, so sums never overflow —
    the uint16 widening doubled tp_consensus memory traffic for nothing."""
    out = np.zeros((len(node_pos), 5), np.uint8)
    nz = node_pos != 0
    idx = np.abs(node_pos[nz]) - 1
    vals = counts[idx]  # uint8 gather; stay narrow until the add
    neg = node_pos[nz] < 0
    if neg.any():
        # complement base lanes only on the reverse-strand rows (a full-array
        # fancy reorder + where copied [nnz,5] twice: 2.4 s/call at 9M cols)
        sel = vals[neg]
        sel[:, :4] = sel[:, 3::-1]
        vals[neg] = sel
    out[nz] = vals
    return out


def inverse_colmap(colmap: np.ndarray, genome_len: int) -> np.ndarray:
    """Signed genome-position -> rep-position map (int64 [genome_len]):
    inv[p-1] = +c when forward-strand genome position p sits at 1-based rep
    column c, -c when reverse, 0 when the position is not carried (cannot
    happen after add_unaligned_intervals, kept for safety)."""
    inv = np.zeros(genome_len, np.int64)
    nz = colmap != 0
    pos = colmap[nz]
    cols = np.nonzero(nz)[0] + 1
    inv[np.abs(pos) - 1] = np.where(pos > 0, cols, -cols)
    return inv


def translate_extant_matches(
    ml, inv_a: np.ndarray, inv_b: np.ndarray, min_len: int = 10
):
    """Translate extant pairwise matches into rep coordinates (the
    reference's translated-anchor semantics: profiles are anchored by
    matches found between EXTANT clade members and lifted through the
    profile's column maps, src/progressiveMauve.cpp:575-710,643-646).

    ml: 2-row MatchList between the two extant genomes; inv_a/inv_b their
    inverse column maps into the two child reps.  Each match expands to
    per-column rep positions; maximal runs where BOTH rep positions advance
    contiguously (+1 per signed step — clade-internal rearrangements and
    indels split runs) become rep-space matches, normalized row0-forward.
    Runs shorter than min_len are dropped (noise control)."""
    from mauvealigner_tpu_torch.core.match import MatchList

    if len(ml) == 0:
        return MatchList.empty(2)
    L = ml.lengths.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(L)])
    total = int(offs[-1])
    midx = np.repeat(np.arange(len(ml)), L)
    t = np.arange(total, dtype=np.int64) - offs[midx]
    Q = np.zeros((2, total), np.int64)
    for r, inv in enumerate((inv_a, inv_b)):
        s = ml.starts[midx, r]
        fwd = s > 0
        gp = np.where(fwd, np.abs(s) + t, np.abs(s) + L[midx] - 1 - t)
        sign = np.where(fwd, 1, -1)
        iv = inv[gp - 1]
        Q[r] = np.where(iv != 0, sign * iv, 0)
    valid = (Q[0] != 0) & (Q[1] != 0)
    brk = np.zeros(total, bool)
    brk[offs[1:-1]] = True  # first column of every match
    brk[0] = True
    for r in range(2):
        cont = np.zeros(total, bool)
        cont[1:] = Q[r][1:] != Q[r][:-1] + 1
        brk |= cont
    prev_valid = np.concatenate([[False], valid[:-1]])
    start = valid & (brk | ~prev_valid)
    run_id = np.cumsum(start) - 1
    idx = np.nonzero(valid)[0]
    if not len(idx):
        return MatchList.empty(2)
    rid = run_id[idx]
    n_runs = int(rid[-1]) + 1
    counts = np.bincount(rid, minlength=n_runs)
    first_col = idx[np.searchsorted(rid, np.arange(n_runs), side="left")]
    keep = counts >= min_len
    if not keep.any():
        return MatchList.empty(2)
    counts, first_col = counts[keep], first_col[keep]
    q0 = Q[0][first_col]
    q1 = Q[1][first_col]
    s0 = np.where(q0 > 0, q0, q0 + counts - 1)
    s1 = np.where(q1 > 0, q1, q1 + counts - 1)
    flip = s0 < 0  # row 0 forward, like the K2 reference component
    s0 = np.where(flip, -s0, s0)
    s1 = np.where(flip, -s1, s1)
    return MatchList(np.stack([s0, s1], axis=1), counts.astype(np.int64)).dedup()


def merge_profiles(
    genomes: Sequence[Genome],
    a: NodeProfile,
    b: NodeProfile,
    aligner_factory,
    node_name: str,
    translated_fn=None,
    profile_closure: bool = True,
    scoring_fn=None,
    prune_private: bool = False,
    prune_private_max_run: int = 20,
) -> NodeProfile:
    """Align the two children's representatives with the full pairwise
    pipeline and compose the column maps.  Unaligned regions ride along as
    single-child columns (IntervalList.add_unaligned_intervals), so nothing
    is lost to higher nodes.

    translated_fn(a, b) -> extra rep-space MatchList (or None): translated
    extant anchors unioned into the node's anchor set before LCB
    determination (profile-aware anchoring for the divergence tail).

    scoring_fn(a, b) -> Optional[(Genome, Genome)]: member-aware stand-in
    genomes (rep coordinates) that the gapped CLOSURE scores instead of the
    consensus reps — the LCA member-aware re-scoring for the divergence
    tail; anchoring still sees the consensus reps."""
    import time

    from mauvealigner_tpu_torch.utils import timing

    t0 = time.perf_counter()
    aligner = aligner_factory()
    if scoring_fn is not None:
        t1 = time.perf_counter()
        stand_ins = scoring_fn(a, b)
        if stand_ins is not None:
            aligner.options.closure_genomes = list(stand_ins)
        timing.GLOBAL.add("tp_scoring_rep_s", time.perf_counter() - t1)
    if translated_fn is None:
        extra = None
    else:
        # deferred: the aligner calls this AFTER its own anchor search, so
        # the translated pass can gate on the found coverage
        def extra(found_ml, _a=a, _b=b):
            t1 = time.perf_counter()
            got = translated_fn(_a, _b, found_ml)
            timing.GLOBAL.add("tp_translate_s", time.perf_counter() - t1)
            return got

    res = aligner.align(
        [a.rep, b.rep],
        extra_matches=extra,
        seq_profiles=[a.counts, b.counts] if profile_closure else None,
    )
    timing.GLOBAL.add("tp_pair_align_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    ivl = res.interval_list
    ivl.add_unaligned_intervals()
    timing.GLOBAL.add("tp_unaligned_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    pos_a, pos_b = _node_alignment_columns(ivl)
    colmaps: Dict[int, np.ndarray] = {}
    for m in a.members:
        colmaps[m] = _compose(a.colmaps[m], pos_a)
    for m in b.members:
        colmaps[m] = _compose(b.colmaps[m], pos_b)
    prof = NodeProfile(a.members + b.members, None, colmaps)
    timing.GLOBAL.add("tp_compose_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    # additive count composition: votes identical to re-deriving from every
    # member (one-hot sums), argmax ties resolve toward the lowest code
    counts = _compose_counts(a.counts, pos_a) + _compose_counts(b.counts, pos_b)
    if prune_private and len(prof.members) >= 3:
        keep = _private_column_keep_mask(counts, prune_private_max_run)
        if not keep.all():
            kc = np.nonzero(keep)[0]
            for m in prof.members:
                colmaps[m] = colmaps[m][kc]
            counts = counts[kc]
    votes = counts[:, :4]
    rep_codes = votes.argmax(axis=1).astype(np.uint8)
    rep_codes[votes.sum(axis=1) == 0] = CODE_N
    # direct construction: from_codes would round-trip int64 -> ASCII ->
    # codes (three full passes over a ~5M-column rep per merge)
    from mauvealigner_tpu_torch.genome.sequence import decode_codes

    prof.rep = Genome(decode_codes(rep_codes), name=node_name)
    prof.counts = counts
    timing.GLOBAL.add("tp_consensus_s", time.perf_counter() - t0)
    return prof


def _private_column_keep_mask(counts: np.ndarray, max_run: int = 20) -> np.ndarray:
    """False where a SHORT run of occupancy<=1 columns should be pruned from
    an internal node profile (>= 3 members).

    Private-insertion columns (exactly one member present) litter the
    consensus rep — at the divergence-tail LCA ~4% of columns — fragmenting
    anchor runs and distorting the node DP's gap placement relative to a
    direct extant alignment (measured: pipeline sn 0.914 vs direct 0.972 on
    the worst sweep pair).  An occupancy-1 column can pair with nothing in a
    later merge's truth, and runs below seed length cannot anchor, so short
    runs are dropped; the carried member positions resurface as unaligned
    single-seq output (IntervalList.add_unaligned_intervals) exactly as the
    truth has them.  Runs longer than max_run (potential clade-specific
    islands — the translated-anchor ride-along semantic, ref cache-db
    src/progressiveMauve.cpp:643-646) are kept.  Occupancy-0 columns are
    dead weight and always pruned."""
    occ = counts.sum(axis=1, dtype=np.int32)
    cand = occ <= 1
    if not cand.any():
        return np.ones(len(occ), bool)
    d = np.diff(np.concatenate([[0], cand.view(np.int8), [0]]))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    cs = np.concatenate([[0], np.cumsum(occ, dtype=np.int64)])
    prune_run = ((ends - starts) <= max_run) | (cs[ends] == cs[starts])
    delta = np.zeros(len(occ) + 1, np.int8)
    delta[starts[prune_run]] = 1
    delta[ends[prune_run]] -= 1
    return np.cumsum(delta[:-1], dtype=np.int32) == 0


def emit_intervals(
    genomes: Sequence[Genome], root: NodeProfile
) -> IntervalList:
    """Expand the root profile to the final n-way IntervalList, splitting at
    every column where any genome's positions break contiguity (signed
    positions advance by exactly +1 between consecutive present columns on
    both strands under the signed-leftmost convention).

    FORWARD jumps (signed step >= 2 — positions skipped by private-column
    pruning, models/tree_progressive._private_column_keep_mask) do NOT
    split: the missing member positions are PATCHED back in as member-only
    columns right before the jump column.  They pair with nothing (exactly
    the truth for private insertions) and keep every row contiguous, so the
    interval structure matches the unpruned pipeline's — without patching,
    ~40k pruned holes per Mbp each split the whole n-way interval and
    refinement/backbone cost exploded with interval count.  Only steps <= 0
    (strand flips / true rearrangements) split."""
    n = len(genomes)
    L = len(root.colmaps[root.members[0]])
    pos = np.zeros((n, L), np.int64)
    for m in root.members:
        pos[m] = root.colmaps[m]
    present = pos != 0
    any_present = present.any(axis=0)
    # break BEFORE column c when, for some genome, the previous present
    # column's position does not precede c's by exactly 1 in a way that
    # cannot be patched (a gap only breaks when the next present position
    # is discontiguous)
    breaks = np.zeros(L, bool)
    # patches[c] -> list of (genome, first_missing_signed, k)
    patches: Dict[int, List[Tuple[int, int, int]]] = {}
    for g in range(n):
        p = pos[g]
        idx = np.nonzero(p != 0)[0]
        if len(idx) < 2:
            continue
        pv = p[idx]
        step = pv[1:] - pv[:-1]
        same_sign = (pv[1:] > 0) == (pv[:-1] > 0)
        fwd_jump = (step >= 2) & same_sign
        if fwd_jump.any():
            # patchable only when the skipped positions exist NOWHERE else
            # in this genome's colmap (a forward jump across an inversion
            # would otherwise duplicate content that lives in another
            # segment — those must split like any rearrangement)
            absp = np.sort(np.abs(pv))
            a1 = np.abs(pv[:-1] + 1)
            a2 = np.abs(pv[1:] - 1)
            lo_abs = np.minimum(a1, a2)
            hi_abs = np.maximum(a1, a2)
            occupied = np.searchsorted(absp, hi_abs, side="right") > np.searchsorted(
                absp, lo_abs, side="left"
            )
            fwd_jump &= ~occupied
        bad = (step != 1) & ~fwd_jump
        breaks[idx[1:][bad]] = True
        for t in np.nonzero(fwd_jump)[0]:
            c = int(idx[1:][t])
            patches.setdefault(c, []).append(
                (g, int(pv[t]) + 1, int(step[t]) - 1)
            )
    # all-gap columns are simply dropped within each segment (via `keep`
    # below); they never violate the contiguity invariant, so no extra
    # breaks are needed around them
    seg_bounds = np.nonzero(breaks)[0]
    edges = np.concatenate([[0], seg_bounds, [L]])
    patch_cols = np.array(sorted(patches), np.int64)
    intervals: List[Interval] = []
    for s0, s1 in zip(edges[:-1], edges[1:]):
        if s1 <= s0:
            continue
        cols = slice(s0, s1)
        sub = pos[:, cols]
        keep = any_present[cols]
        if not keep.any():
            continue
        # splice pruned-hole patches in BEFORE their jump column (a patch
        # whose column starts this segment becomes its first columns)
        lo = np.searchsorted(patch_cols, s0, side="left")
        hi = np.searchsorted(patch_cols, s1, side="left")
        if hi > lo:
            w = s1 - s0
            pcs = patch_cols[lo:hi]
            ins_at = pcs - s0  # insert before this local column
            # flatten every patch of this segment (column order, then list
            # order within a column) — the per-patch python loop this
            # replaces was ~300k tiny slice assignments at headline scale
            g_arr, first_arr, k_arr, col_idx = [], [], [], []
            for ci, c in enumerate(pcs):
                for (g, first, k) in patches[int(c)]:
                    g_arr.append(g)
                    first_arr.append(first)
                    k_arr.append(k)
                    col_idx.append(ci)
            g_arr = np.array(g_arr, np.int64)
            first_arr = np.array(first_arr, np.int64)
            k_arr = np.array(k_arr, np.int64)
            col_idx = np.array(col_idx, np.int64)
            ks = np.zeros(len(pcs), np.int64)
            np.add.at(ks, col_idx, k_arr)
            new_w = w + int(ks.sum())
            # local col -> output col offset: +sum of insertions before it
            shift = np.zeros(w + 1, np.int64)
            shift[ins_at] += ks
            shift = np.cumsum(shift)[:w]
            out = np.zeros((n, new_w), np.int64)
            out[:, np.arange(w) + shift] = sub
            okeep = np.zeros(new_w, bool)
            okeep[np.arange(w) + shift] = keep
            # per-column insertion block base, then per-patch start =
            # base + cumsum of earlier same-column patch widths
            base = ins_at + shift[ins_at] - ks
            kcum = np.cumsum(k_arr) - k_arr
            col_kcum_start = np.zeros(len(pcs), np.int64)
            firsts_per_col = np.unique(col_idx, return_index=True)[1]
            col_kcum_start[np.unique(col_idx)] = kcum[firsts_per_col]
            p_start = base[col_idx] + (kcum - col_kcum_start[col_idx])
            total = int(k_arr.sum())
            intra = np.arange(total, dtype=np.int64) - np.repeat(kcum, k_arr)
            rows = np.repeat(g_arr, k_arr)
            cols_out = np.repeat(p_start, k_arr) + intra
            out[rows, cols_out] = np.repeat(first_arr, k_arr) + intra
            okeep[cols_out] = True
            sub = out[:, okeep]
        else:
            sub = sub[:, keep]
        aln = sub != 0
        starts = np.zeros(n, np.int64)
        for g in range(n):
            nzg = np.nonzero(sub[g])[0]
            if not len(nzg):
                continue
            first, last = sub[g, nzg[0]], sub[g, nzg[-1]]
            starts[g] = first if first > 0 else last
        intervals.append(Interval(starts, aln))
    return IntervalList(genomes=list(genomes), intervals=intervals)


def lcbs_from_intervals(ivl: IntervalList) -> List[LCB]:
    """Block descriptors for reporting (weight = column count)."""
    out = []
    for iv in ivl.intervals:
        if iv.multiplicity() < 2:
            continue
        lens = iv.aln.sum(axis=1).astype(np.int64)
        lefts = np.abs(iv.starts)
        rights = np.where(lefts > 0, lefts + lens - 1, 0)
        out.append(
            LCB(
                match_indices=np.zeros(0, np.int64),
                weight=float(iv.n_cols),
                lefts=np.where(iv.starts != 0, lefts, 0),
                rights=rights,
                strands=np.sign(iv.starts).astype(np.int8),
            )
        )
    return out


def merge_plan(genomes, tree) -> Tuple[List[Tuple[str, object, object]], object]:
    """Flatten the guide tree into a binary merge DAG.

    Returns (tasks, root_ref): tasks[t] = (node_name, left_ref, right_ref)
    where a ref is ("leaf", genome_index) or ("task", task_index); root_ref
    is the ref holding the final profile.  Node names follow the serial
    post-order numbering, so results are independent of execution order."""
    tasks: List[Tuple[str, object, object]] = []

    def build(node):
        if node.is_leaf:
            i = int(node.name)
            if not 0 <= i < len(genomes):
                raise ValueError(
                    f"guide-tree leaf {node.name!r} is not a 0-based genome "
                    f"index (n_genomes={len(genomes)})"
                )
            return ("leaf", i)
        cur = build(node.children[0])
        for child in node.children[1:]:
            right = build(child)
            tasks.append((f"node{len(tasks) + 1}", cur, right))
            cur = ("task", len(tasks) - 1)
        return cur

    return tasks, build(tree)


def _in_callers_context(fn):
    """fn wrapped to run under the calling thread's ambient mesh and current
    CUDA device.  Both are per thread (parallel/context.py, the CUDA
    runtime): a pool worker would otherwise drop a mesh the caller entered
    with use_mesh, running its batches unsplit, and launch on device 0."""
    import contextlib

    import torch

    from mauvealigner_tpu_torch.parallel.context import active_mesh, use_mesh

    mesh = active_mesh()
    cuda_dev = torch.cuda.current_device() if torch.cuda.is_initialized() else None

    def run(*args):
        dev_ctx = (torch.cuda.device(cuda_dev) if cuda_dev is not None
                   else contextlib.nullcontext())
        with use_mesh(mesh), dev_ctx:
            return fn(*args)

    return run


def tree_progressive_align(
    genomes: Sequence[Genome],
    tree,
    aligner_factory,
    max_workers: Optional[int] = None,
    translated_fn=None,
    profile_closure: bool = True,
    scoring_fn=None,
    prune_private: bool = False,
    prune_private_max_run: int = 20,
) -> Tuple[IntervalList, List[LCB]]:
    """Consensus-ladder alignment up the guide tree; returns
    (intervals, blocks).

    aligner_factory() -> a configured MauveAligner for one pairwise node
    merge (a fresh instance per node: the aligner caches per-run state).

    Independent merges (sibling subtrees whose children are both ready) run
    concurrently on a thread pool of max_workers threads (None reads
    MAUVE_TP_WORKERS, default 1: the serial post-order).  Each merge is a
    pure function of its two child profiles, so results are identical to
    the serial order.  Workers run under the caller's ambient mesh and CUDA
    device, and launch on their thread's current stream."""
    import os
    import time

    from mauvealigner_tpu_torch.utils import timing

    tasks, root_ref = merge_plan(genomes, tree)
    if max_workers is None:
        max_workers = int(os.environ.get("MAUVE_TP_WORKERS", "1"))
    profiles: Dict[object, NodeProfile] = {}
    for name, l, r in tasks:
        for ref in (l, r):
            if ref[0] == "leaf" and ref not in profiles:
                profiles[ref] = leaf_profile(ref[1], genomes[ref[1]])
    if not tasks:  # single leaf
        profiles[root_ref] = leaf_profile(root_ref[1], genomes[root_ref[1]])

    if max_workers <= 1 or len(tasks) <= 1:
        for t, (name, l, r) in enumerate(tasks):
            profiles[("task", t)] = merge_profiles(
                genomes, profiles[l], profiles[r], aligner_factory, name,
                translated_fn, profile_closure, scoring_fn,
                prune_private, prune_private_max_run,
            )
    else:
        import concurrent.futures as cf

        merge = _in_callers_context(merge_profiles)
        t0 = time.perf_counter()
        remaining = set(range(len(tasks)))
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            pending: Dict[object, int] = {}
            while remaining or pending:
                for t in sorted(remaining):
                    name, l, r = tasks[t]
                    if l in profiles and r in profiles:
                        remaining.discard(t)
                        fut = ex.submit(
                            merge, genomes,
                            profiles[l], profiles[r], aligner_factory, name,
                            translated_fn, profile_closure, scoring_fn,
                            prune_private, prune_private_max_run,
                        )
                        pending[fut] = t
                if not pending:  # malformed DAG (cannot happen from a tree)
                    raise RuntimeError(
                        f"merge plan stalled with tasks {sorted(remaining)} unready"
                    )
                done, _ = cf.wait(list(pending), return_when=cf.FIRST_COMPLETED)
                for fut in done:
                    t = pending.pop(fut)
                    profiles[("task", t)] = fut.result()  # re-raises errors
        timing.GLOBAL.add("tp_ladder_wall_s", time.perf_counter() - t0)

    root = profiles[root_ref]
    t0 = time.perf_counter()
    ivl = emit_intervals(genomes, root)
    out = ivl, lcbs_from_intervals(ivl)
    timing.GLOBAL.add("tp_emit_s", time.perf_counter() - t0)
    return out
