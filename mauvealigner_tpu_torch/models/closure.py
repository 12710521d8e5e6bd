"""Gapped closure: align the inter-anchor regions of an LCB.

Port of mauvealigner_tpu/models/closure.py, which replaces the reference's
per-region MUSCLE subprocess (Aligner::align gapped phase,
src/mauveAligner.cpp:674-676; ProgressiveAligner's per-node profile
alignment, src/progressiveMauve.cpp:575-710) with batched DP on the device.

Two modes share one engine:
  * star-progressive (MauveAligner): sequences join a growing profile in
    index order;
  * guide-tree hierarchical (ProgressiveAligner): profiles are merged in
    postorder of the guide tree.

At every merge round, ALL gap regions' pairs are bucketed by length and
aligned in one batched Gotoh launch per bucket chunk (ops/dp.py): code pairs
for leaf-leaf merges, uint8 count profiles for merges with a multi-row side.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.ops import dp
from mauvealigner_tpu_torch.utils import timing

PROFILE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

NodeId = Union[int, str]
# merge-node state: (member seq ids int32 [m], column codes int8 [m, n_cols];
# values 0..4 are bases (4 = N), 5 = gap)
State = Tuple[np.ndarray, np.ndarray]
GAP = 5


def chain_plan(n_seqs: int) -> List[Tuple[NodeId, NodeId, NodeId]]:
    """Star-progressive merge plan: ((0+1)+2)+3 ..."""
    steps: List[Tuple[NodeId, NodeId, NodeId]] = []
    prev: NodeId = 0
    for s in range(1, n_seqs):
        node = f"n{s}"
        steps.append((node, prev, s))
        prev = node
    return steps


def balanced_plan(n_seqs: int) -> List[Tuple[NodeId, NodeId, NodeId]]:
    """Balanced binary merge plan: ceil(log2 n) ROUNDS of pairwise merges
    instead of the star chain's n-1 sequential rounds.  Each round of a
    hierarchical closure is one batched device pass, so a mult-10 repeat
    family's extension wave drops from 9 sequential DP calls to 4
    (repeatoire's ExtendMatch flank
    alignment; the reference's MUSCLE call builds its own guide tree, so
    neither order is more reference-faithful than the other)."""
    steps: List[Tuple[NodeId, NodeId, NodeId]] = []
    layer: List[NodeId] = list(range(n_seqs))
    c = 0
    while len(layer) > 1:
        nxt: List[NodeId] = []
        for i in range(0, len(layer) - 1, 2):
            c += 1
            nid = f"n{c}"
            steps.append((nid, layer[i], layer[i + 1]))
            nxt.append(nid)
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return steps


def tree_plan(tree) -> List[Tuple[NodeId, NodeId, NodeId]]:
    """Postorder merge plan from a guide tree whose leaf names are sequence
    indices (as str or int)."""
    steps: List[Tuple[NodeId, NodeId, NodeId]] = []
    counter = [0]

    def rec(node) -> NodeId:
        if node.is_leaf:
            return int(node.name)
        ids = [rec(c) for c in node.children]
        cur = ids[0]
        for other in ids[1:]:
            counter[0] += 1
            nid = f"n{counter[0]}"
            steps.append((nid, cur, other))
            cur = nid
        return cur

    rec(tree)
    return steps


def _profile_of(cc: np.ndarray) -> np.ndarray:
    """[m, n_cols] column codes -> [n_cols, 5] base counts (gaps excluded).
    One bincount pass over (column, symbol) cells; GAP (=5) lands in the
    dropped sixth slot.  uint8 when counts fit (the device widens them),
    float32 above 255 rows."""
    T = cc.shape[1]
    flat = np.arange(T, dtype=np.int64) * 6 + cc
    counts = np.bincount(flat.ravel(), minlength=T * 6).reshape(T, 6)
    dt = np.uint8 if cc.shape[0] < 256 else np.float32
    return counts[:, :5].astype(dt)


def _profiles_of_many(ccs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """_profile_of for many matrices through ONE bincount over globally
    offset (column, symbol) cells (the per-call bincount overhead dominated
    at tens of thousands of merge jobs per round)."""
    offs = np.zeros(len(ccs) + 1, np.int64)
    for i, cc in enumerate(ccs):
        offs[i + 1] = offs[i] + cc.shape[1]
    total = int(offs[-1])
    small = all(cc.shape[0] < 256 for cc in ccs)
    dt = np.uint8 if small else np.float32
    if total == 0:
        return [np.zeros((cc.shape[1], 5), dt) for cc in ccs]
    flats = [
        ((np.arange(cc.shape[1], dtype=np.int64) + offs[i]) * 6 + cc).ravel()
        for i, cc in enumerate(ccs)
    ]
    counts = (
        np.bincount(np.concatenate(flats), minlength=total * 6)
        .reshape(total, 6)[:, :5]
        .astype(dt)
    )
    return [counts[offs[i] : offs[i + 1]] for i in range(len(ccs))]


def _unaligned_blocks(regs: Sequence[np.ndarray]) -> np.ndarray:
    total = sum(len(r) for r in regs)
    aln = np.zeros((len(regs), total), dtype=bool)
    off = 0
    for i, r in enumerate(regs):
        aln[i, off : off + len(r)] = True
        off += len(r)
    return aln


def _pairwise_align_region_groups(
    groups, subst, gap_open, gap_extend, max_len, device
) -> List[np.ndarray]:
    """Single-merge fast path of hierarchical_align_region_groups for
    PAIRWISE groups: stage the code pairs straight into the bucketed batch
    and build each gap's boolean rows from the op string (output identical
    to the general path, whose one merge step degenerates to exactly this).
    Empty regions give empty or one-sided blocks; regions over max_len are
    emitted unaligned (--max-gapped-aligner-length semantics,
    src/mauveAligner.cpp:675-676)."""
    results: List[Optional[np.ndarray]] = [None] * len(groups)
    pairs, pidx = [], []
    for k, regs in enumerate(groups):
        a, b = regs
        la, lb = len(a), len(b)
        if la == 0 and lb == 0:
            results[k] = np.zeros((2, 0), bool)
        elif la > max_len or lb > max_len:
            results[k] = _unaligned_blocks(regs)
        elif la == 0 or lb == 0:
            aln = np.zeros((2, la + lb), bool)
            aln[0, :la] = True
            aln[1, la:] = True
            results[k] = aln
        else:
            pairs.append((a, b))
            pidx.append(k)
    if pairs:
        ops_list = _batched_code_pair_align(pairs, subst, gap_open, gap_extend, device)
        for k, ops in zip(pidx, ops_list):
            ra, rb = dp.ops_to_gap_rows(ops)
            results[k] = np.stack([ra, rb])
    return results  # type: ignore[return-value]


def hierarchical_align_region_groups(
    groups: Sequence[Sequence[np.ndarray]],
    plan: Optional[List[Tuple[NodeId, NodeId, NodeId]]] = None,
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
    max_len: int = 4096,
    device="cuda",
) -> List[np.ndarray]:
    """Align many groups of regions following a shared merge plan.

    groups[k][s] is the (possibly empty) match-space-oriented code array of
    sequence s in gap region k.  Returns per-group boolean alignment
    matrices [n_seqs, n_cols].  Groups exceeding max_len fall back to
    unaligned block emission (--max-gapped-aligner-length semantics,
    src/mauveAligner.cpp:675-676).
    """
    n_groups = len(groups)
    if n_groups == 0:
        return []
    n_seqs = len(groups[0])
    if n_seqs == 2 and (plan is None or len(plan) <= 1):
        return _pairwise_align_region_groups(
            groups, subst, gap_open, gap_extend, max_len, device
        )
    if plan is None:
        plan = chain_plan(n_seqs)
    _t0 = time.perf_counter()
    results: List[Optional[np.ndarray]] = [None] * n_groups
    state: List[Dict[NodeId, State]] = []
    for k, regs in enumerate(groups):
        st: Dict[NodeId, State] = {}
        for s, r in enumerate(regs):
            if len(r) > 0:
                arr = np.asarray(r)
                if arr.dtype != np.int8:  # int8 callers pass codes <= 4
                    arr = np.minimum(arr, 4).astype(np.int8)
                st[s] = (np.array([s], np.int32), arr[None, :])
        state.append(st)
        if regs and max(map(len, regs)) > max_len:
            results[k] = _unaligned_blocks(regs)
    timing.GLOBAL.add("cl_hier_setup_s", time.perf_counter() - _t0)

    for node, left, right in plan:
        jobs = []  # (k, (idsA, ccA), (idsB, ccB))
        for k in range(n_groups):
            if results[k] is not None:
                continue
            st = state[k]
            A, B = st.pop(left, None), st.pop(right, None)
            if A is None and B is None:
                continue
            if A is None or B is None:
                st[node] = A if B is None else B
                continue
            if A[1].shape[1] > max_len or B[1].shape[1] > max_len:
                results[k] = _unaligned_blocks(groups[k])
                continue
            jobs.append((k, A, B))
        if not jobs:
            continue
        # leaf-leaf merges are plain sequence pairs (the code-pair kernel);
        # multi-row sides go through uint8 count profiles
        code_idx, prof_idx = [], []
        for i, (_, A, B) in enumerate(jobs):
            (code_idx if len(A[0]) == 1 and len(B[0]) == 1 else prof_idx).append(i)
        ops_all: List[Optional[np.ndarray]] = [None] * len(jobs)
        if code_idx:
            code_pairs = [(jobs[i][1][1][0], jobs[i][2][1][0]) for i in code_idx]
            got = _batched_code_pair_align(code_pairs, subst, gap_open, gap_extend, device)
            for i, ops in zip(code_idx, got):
                ops_all[i] = ops
        if prof_idx:
            profs = _profiles_of_many(
                [m for i in prof_idx for m in (jobs[i][1][1], jobs[i][2][1])]
            )
            prof_pairs = []
            for n, i in enumerate(prof_idx):
                (_, A, B) = jobs[i]
                prof_pairs.append(
                    (
                        profs[2 * n],
                        A[1].shape[1],
                        profs[2 * n + 1],
                        B[1].shape[1],
                    )
                )
            got = _batched_profile_pair_align(
                prof_pairs, subst, gap_open, gap_extend, device
            )
            for i, ops in zip(prof_idx, got):
                ops_all[i] = ops
        _t0 = time.perf_counter()
        for (k, A, B), ops in zip(jobs, ops_all):
            consumes_a = (ops == dp.OP_DIAG) | (ops == dp.OP_UP)
            consumes_b = (ops == dp.OP_DIAG) | (ops == dp.OP_LEFT)
            kA = A[1].shape[0]
            merged = np.full((kA + B[1].shape[0], len(ops)), GAP, np.int8)
            merged[:kA, consumes_a] = A[1]
            merged[kA:, consumes_b] = B[1]
            state[k][node] = (np.concatenate([A[0], B[0]]), merged)
        timing.GLOBAL.add("cl_hier_merge_s", time.perf_counter() - _t0)

    for k in range(n_groups):
        if results[k] is not None:
            continue
        st = state[k]
        if not st:
            results[k] = np.zeros((n_seqs, 0), dtype=bool)
            continue
        ids, cc = max(st.values(), key=lambda t: len(t[0]))
        aln = np.zeros((n_seqs, cc.shape[1]), dtype=bool)
        aln[ids] = cc != GAP
        placed = set(ids.tolist())
        # any sequence whose region never merged (shouldn't happen with a
        # complete plan) falls back to unaligned emission
        leftovers = [
            s
            for other in st.values()
            if other[0] is not ids
            for s in other[0].tolist()
            if s not in placed
        ]
        if leftovers:
            extra_blocks = [aln]
            for s in leftovers:
                r = groups[k][s]
                block = np.zeros((n_seqs, len(r)), dtype=bool)
                block[s] = True
                extra_blocks.append(block)
            aln = np.concatenate(extra_blocks, axis=1)
        results[k] = aln
    return results  # type: ignore[return-value]


def align_region_groups(
    groups: Sequence[Sequence[np.ndarray]],
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
    max_len: int = 4096,
    device="cuda",
) -> List[np.ndarray]:
    """Star-progressive closure (MauveAligner mode)."""
    return hierarchical_align_region_groups(
        groups, None, subst, gap_open, gap_extend, max_len, device
    )


def _batched_code_pair_align(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    subst: np.ndarray,
    gap_open: float,
    gap_extend: float,
    device,
    memory_budget_bytes: int = 3 << 29,
) -> List[np.ndarray]:
    """Bucket plain sequence pairs by side and run batched Gotoh; each
    launch holds at most memory_budget_bytes of decision bytes (the only
    per-problem device buffer).  Output does not depend on the chunking."""
    results: List[Optional[np.ndarray]] = [None] * len(pairs)
    buckets: dict = {}
    for i, (a, b) in enumerate(pairs):
        side = _bucket_of(max(len(a), len(b)))
        buckets.setdefault(side, []).append(i)
    pending = []  # (chunk, fetch): launch everything, then download
    t0 = time.perf_counter()
    for side, idxs in buckets.items():
        bmax = max(1, min(4096, memory_budget_bytes // dp.dec_bytes(side, side)))
        for off in range(0, len(idxs), bmax):
            chunk = idxs[off : off + bmax]
            ca = np.full((len(chunk), side), 255, np.uint8)
            cb = np.full((len(chunk), side), 255, np.uint8)
            la = np.zeros(len(chunk), np.int32)
            lb = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                a, b = pairs[i]
                ca[j, : len(a)] = np.minimum(a, 4)
                cb[j, : len(b)] = np.minimum(b, 4)
                la[j], lb[j] = len(a), len(b)
            pending.append((chunk, dp.align_code_pairs_batch_async(
                ca, cb, la, lb, subst, gap_open, gap_extend, device
            )))
    timing.GLOBAL.add("cl_dp_stage_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    for chunk, fetch in pending:
        ops_list, _ = fetch()
        for j, i in enumerate(chunk):
            results[i] = ops_list[j]
    timing.GLOBAL.add("cl_dp_fetch_s", time.perf_counter() - t0)
    return results  # type: ignore[return-value]


def _batched_profile_pair_align(
    pairs: List[Tuple[np.ndarray, int, np.ndarray, int]],
    subst: np.ndarray,
    gap_open: float,
    gap_extend: float,
    device,
    memory_budget_bytes: int = 3 << 29,
    normalize: bool = False,
) -> List[np.ndarray]:
    """Bucket (profileA, lenA, profileB, lenB) pairs by side and run batched
    Gotoh over the profiles; each launch holds at most memory_budget_bytes
    of decision bytes.  normalize=True scores mean pairwise substitution
    (profile-aware node merges; see dp.align_profiles_batch)."""
    results: List[Optional[np.ndarray]] = [None] * len(pairs)
    buckets: dict = {}
    for i, (_, la, _, lb) in enumerate(pairs):
        side = _bucket_of(max(la, lb))
        buckets.setdefault(side, []).append(i)
    pending = []  # (chunk, fetch): launch everything, then download
    t0 = time.perf_counter()
    for side, idxs in buckets.items():
        M = N = side
        bmax = max(1, min(4096, memory_budget_bytes // dp.dec_bytes(M, N)))
        for off in range(0, len(idxs), bmax):
            chunk = idxs[off : off + bmax]
            B = len(chunk)
            # uint8 counts when every profile in the chunk is uint8 (the
            # device widens them to f32)
            dt = (
                np.uint8
                if all(
                    pairs[i][0].dtype == np.uint8
                    and pairs[i][2].dtype == np.uint8
                    for i in chunk
                )
                else np.float32
            )
            pa = np.zeros((B, M, 5), dt)
            pb = np.zeros((B, N, 5), dt)
            la = np.zeros(B, np.int32)
            lb = np.zeros(B, np.int32)
            for j, i in enumerate(chunk):
                prof_a, len_a, prof_b, len_b = pairs[i]
                pa[j, :len_a] = prof_a[:len_a]
                pb[j, :len_b] = prof_b[:len_b]
                la[j], lb[j] = len_a, len_b
            pending.append((chunk, dp.align_profiles_batch_async(
                pa, pb, la, lb, subst, gap_open, gap_extend, normalize, device
            )))
    timing.GLOBAL.add("cl_dp_stage_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    for chunk, fetch in pending:
        ops_list, _ = fetch()
        for j, i in enumerate(chunk):
            results[i] = ops_list[j]
    timing.GLOBAL.add("cl_dp_fetch_s", time.perf_counter() - t0)
    return results  # type: ignore[return-value]


def _bucket_of(n: int) -> int:
    """Smallest DP side covering n; above the table (user-raised
    --max-gapped-aligner-length) continue with powers of two."""
    if n > PROFILE_BUCKETS[-1]:
        return 1 << (n - 1).bit_length()
    for b in PROFILE_BUCKETS:
        if n <= b:
            return b
    return PROFILE_BUCKETS[-1]
