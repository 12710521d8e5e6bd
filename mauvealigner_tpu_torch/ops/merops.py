"""K1: spaced-mer packing and strand canonicalization, in torch.

Port of mauvealigner_tpu/ops/merops.py (pack_canonical_mers, build_mer_list,
the sorted variants build_sorted_mer_list and sort_key_pos, and the host
unique_mer_count over a sorted list);
libMems SortedMerList/DNAFileSML construction in the reference
(src/mauveAligner.cpp:365, src/progressiveMauve.cpp:447).

Semantics reproduced:
  * a mer is the concatenation of the 2-bit codes at the seed's care
    positions within an L-wide window;
  * each window is strand-canonicalized: the smaller of (forward mer,
    reverse-complement mer) is stored, shifted left one bit, with the LSB set
    iff the reverse-complement orientation won (``GetMer(pos) & 0x1``,
    src/SeedMatchEnumerator.h:133); palindromic seed patterns only;
  * windows with an ambiguity code at a care position get INVALID_KEY.

For a palindromic pattern with care offsets o_0<...<o_{w-1}:
  fwd(i) = sum_j code[i+o_j] << 2(w-1-j)
  rc(i)  = sum_j (3 - code[i+o_j]) << 2j

The JAX package's 2-bit packed upload and padding-bucket ladders existed for
its host link and its compile cache; here codes upload as bytes and every
array has its natural length.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.genome.sequence import CODE_N

INVALID_KEY = 2**62  # sorts after every valid key: valid keys use 2w+1 <= 61
# bits (MAX_SEED_WEIGHT 30, seeds.py)


def pack_canonical_mers(
    codes: torch.Tensor, offsets: Sequence[int], pattern_len: int
) -> torch.Tensor:
    """codes: integer [P] (2-bit codes, CODE_N for ambiguity/padding) ->
    canonical keys int64 [P-L+1].

    Key layout: (min(fwd, rc) << 1) | (1 if rc < fwd else 0); invalid windows
    get INVALID_KEY.
    """
    n_pos = codes.shape[0] - pattern_len + 1
    w = len(offsets)
    fwd = torch.zeros(n_pos, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    invalid = torch.zeros(n_pos, dtype=torch.bool, device=codes.device)
    for j, off in enumerate(offsets):
        c = codes[off : off + n_pos].to(torch.int64)
        invalid |= c >= CODE_N
        fwd += c << (2 * (w - 1 - j))
        rc += (3 - c) << (2 * j)
    use_rc = rc < fwd
    key = (torch.where(use_rc, rc, fwd) << 1) | use_rc.to(torch.int64)
    return torch.where(invalid, torch.full_like(key, INVALID_KEY), key)


def build_mer_list(
    codes: torch.Tensor, offsets: Sequence[int], pattern_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 pack without a sort: (keys int64 [n_pos], positions int32 [n_pos]),
    in position order, INVALID entries interspersed.  The multi-MUM search
    sorts the concatenated lists of all genomes itself."""
    keys = pack_canonical_mers(codes, offsets, pattern_len)
    positions = torch.arange(keys.shape[0], dtype=torch.int32, device=codes.device)
    return keys, positions


def sort_key_pos(keys: torch.Tensor, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (key, position) pairs by key, then position.  `positions` must be
    ascending (an iota): one stable sort by the int64 key then gives the
    (key, position) order.  The JAX package splits the key into 32-bit
    halves and has an int32 fast path for small seeds; both only suited the
    TPU's sort lanes and give the same order."""
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, positions[order]


def build_sorted_mer_list(
    codes: torch.Tensor, offsets: Sequence[int], pattern_len: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full K1 pipeline: pack, canonicalize, sort.

    Returns (keys int64 [n_pos], positions int32 [n_pos], n_valid): sorted by
    (key, position), positions 0-based window starts, INVALID_KEY entries at
    the tail and counted out by n_valid."""
    keys, positions = build_mer_list(codes, offsets, pattern_len)
    keys_s, pos_s = sort_key_pos(keys, positions)
    n_valid = int((keys_s != INVALID_KEY).sum())
    return keys_s, pos_s, n_valid


def unique_mer_count(sorted_keys: np.ndarray, n_valid: int) -> int:
    """Number of distinct strand-free mers that occur exactly once
    (UniqueMerCount; reference tool src/uniqueMerCount.cpp:30-39), on the
    host over a sorted key list."""
    mers = np.asarray(sorted_keys[:n_valid]) >> 1
    if len(mers) == 0:
        return 0
    # keys ascending => mers (key >> 1) ascending: the strand LSB cannot
    # reorder distinct mers, so no re-sort is needed
    new_run = np.concatenate([[True], mers[1:] != mers[:-1]])
    run_ids = np.cumsum(new_run) - 1
    counts = np.bincount(run_ids)
    return int(np.sum(counts == 1))
