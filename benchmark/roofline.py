"""The least time one H100 needs for the Gotoh kernels' work.

Frozen copies of scripts/gotoh_replay.py's forward_bound and
traceback_bound: bytes over the published HBM bandwidth or float32
operations over the published non-tensor-core float32 rate, the larger,
counted from each DP problem's own lengths, so the bound reads the same work
whatever kernel implements it.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per live cell: E, F (an add, a compare, a max each), the
# diagonal add and two compares; a profile cell adds 5 products and 4 sums
OPS_PER_CELL = {"gotoh_forward_codes": 12, "gotoh_forward_profiles": 21}
# input bytes per live row: a code byte, or 5 f32 counts
ROW_BYTES = {"gotoh_forward_codes": 1, "gotoh_forward_profiles": 20}


def forward_bound_s(kernel: str, la, lb) -> float:
    """One forward launch: each live input row read once, the lengths read
    and the score written (12 bytes a problem), a decision byte per live
    cell; or its operations, whichever takes longer."""
    la = np.asarray(la, np.int64)
    lb = np.asarray(lb, np.int64)
    cells = float(((la + 1) * (lb + 1)).sum())
    nbytes = float((la + lb).sum()) * ROW_BYTES[kernel] + 12.0 * len(la) + cells
    return max(nbytes / HBM_BYTES_PER_S, cells * OPS_PER_CELL[kernel] / F32_OPS_PER_S)


def traceback_bound_s(la, lb, M: int, N: int) -> float:
    """The traceback of one launch: a decision byte read per step, the
    lengths read, the op rows and counts written.  A walk takes at least
    max(la, lb) steps, the count used here."""
    steps = np.maximum(np.asarray(la, np.int64), np.asarray(lb, np.int64))
    nbytes = float(steps.sum()) + float(len(steps)) * (M + N + 12)
    return nbytes / HBM_BYTES_PER_S


def launches_bound_s(shapes) -> float:
    """Forward and traceback bound of every recorded forward launch
    (gotoh_cuda.LAUNCH_SHAPES: kernel, M, N, lens_a, lens_b)."""
    total = 0.0
    for s in shapes:
        total += forward_bound_s(s["kernel"], s["lens_a"], s["lens_b"])
        total += traceback_bound_s(s["lens_a"], s["lens_b"], int(s["M"]), int(s["N"]))
    return total
