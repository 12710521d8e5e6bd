"""Sub-genome helpers for LCB extension (from mauvealigner_tpu/models/subset.py).

Region extraction concatenates each genome's uncovered regions with N-run
spacers (no seed window can span a spacer), and maps match coordinates back
through a per-region offset table.  The subset-LCB detection of the JAX
module belongs to the progressive aligner and is not part of this slice.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Genome

_SPACER = 64  # >= max seed length


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
