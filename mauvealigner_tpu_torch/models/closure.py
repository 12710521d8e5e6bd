"""Gapped closure: align the inter-anchor regions of an LCB.

Port of the pairwise path of mauvealigner_tpu/models/closure.py, which
replaces the reference's per-region MUSCLE subprocess (Aligner::align gapped
phase, src/mauveAligner.cpp:674-676) with batched DP on the device: every
gap region's code pair is bucketed by length and aligned in one batched
Gotoh launch per bucket chunk (ops/dp.py).

Groups of more than two sequences need count-profile DP (the hierarchical
driver of the JAX module); that is slice 2 of the port and raises here.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu_torch.ops import dp
from mauvealigner_tpu_torch.utils import timing

PROFILE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


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
    """Closure of PAIRWISE groups: stage the code pairs straight into the
    bucketed batch and build each gap's boolean rows from the op string.
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


def align_region_groups(
    groups: Sequence[Sequence[np.ndarray]],
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
    max_len: int = 4096,
    device="cuda",
) -> List[np.ndarray]:
    """Closure of many gap groups (MauveAligner mode).

    groups[k][s] is the (possibly empty) match-space-oriented code array of
    sequence s in gap region k.  Returns per-group boolean alignment
    matrices [n_seqs, n_cols]."""
    if len(groups) == 0:
        return []
    n_seqs = len(groups[0])
    if n_seqs != 2:
        raise NotImplementedError(
            f"gapped closure of {n_seqs} sequences needs count-profile DP: "
            "ROADMAP Queue A, 'hierarchical closure for more than two sequences'"
        )
    return _pairwise_align_region_groups(
        groups, subst, gap_open, gap_extend, max_len, device
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


def _bucket_of(n: int) -> int:
    """Smallest DP side covering n; above the table (user-raised
    --max-gapped-aligner-length) continue with powers of two."""
    if n > PROFILE_BUCKETS[-1]:
        return 1 << (n - 1).bit_length()
    for b in PROFILE_BUCKETS:
        if n <= b:
            return b
    return PROFILE_BUCKETS[-1]
