"""Spaced-seed registry (L1).

API parity with libMems' seed registry as used by the reference apps:
``getSeed(weight, rank)`` / ``getSeedLength`` / ``getDefaultSeedWeight``
(call sites src/progressiveMauve.cpp:197-224,504-518) and the seed classes
SOLID_SEED / CODING_SEED / spaced ranks 0-2 (src/mauveAligner.cpp:263-279).

The concrete patterns are NOT copied from libMems (its sources are not in the
reference snapshot); they are generated deterministically with the same
structural requirements:

* **palindromic** — a window's reverse complement is sampled by the same
  pattern, so one sorted mer list serves both strands with a canonical-strand
  bit in the mer LSB (GetMer LSB semantics, src/SeedMatchEnumerator.h:133);
* solid first/last positions;
* three ranks per weight with distinct lengths/densities forming a seed
  family (searched longest-first, src/progressiveMauve.cpp:504-548):
  rank 0 density ~2/3 (unit 110), rank 1 density ~3/4 (unit 1110),
  rank 2 density ~1/2 (unit 10).
* CODING_SEED uses the codon-wobble period-3 layout ``11(011)^k`` (which is
  palindromic); even weights only — odd weights round down.
* SOLID_SEED is a contiguous run of 1s.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

SOLID_SEED = -1
CODING_SEED = -2
MIN_SEED_WEIGHT = 3
MAX_SEED_WEIGHT = 30  # 2*30+1 = 61 key bits: fits int64 below the INVALID_KEY sentinel


@dataclasses.dataclass(frozen=True)
class Seed:
    pattern: str  # e.g. "1101011"
    rank: int

    @property
    def weight(self) -> int:
        return self.pattern.count("1")

    @property
    def length(self) -> int:
        return len(self.pattern)

    @property
    def offsets(self) -> np.ndarray:
        """Indices of care (1) positions within the window."""
        return np.array([i for i, c in enumerate(self.pattern) if c == "1"], dtype=np.int32)

    @property
    def is_palindromic(self) -> bool:
        return self.pattern == self.pattern[::-1]

    def __str__(self) -> str:
        return self.pattern


def _half_from_unit(unit: str, ones: int) -> str:
    """Leading fragment of repeated `unit` containing `ones` 1s, '1'-terminal."""
    out = []
    count = 0
    i = 0
    while count < ones:
        c = unit[i % len(unit)]
        out.append(c)
        count += c == "1"
        i += 1
    while out and out[-1] == "0":
        out.pop()
    return "".join(out)


@lru_cache(maxsize=None)
def get_seed(weight: int, rank: int = 0) -> Seed:
    """Return the seed of the given weight and rank.

    rank in {0,1,2} selects a spaced-seed family member; SOLID_SEED and
    CODING_SEED select those classes (mirrors the reference enum,
    src/mauveAligner.cpp:263-279).
    """
    if not (MIN_SEED_WEIGHT <= weight <= MAX_SEED_WEIGHT):
        raise ValueError(f"seed weight {weight} outside [{MIN_SEED_WEIGHT},{MAX_SEED_WEIGHT}]")
    if rank == SOLID_SEED:
        return Seed("1" * weight, rank)
    if rank == CODING_SEED:
        k = max((weight - 2) // 2, 0)
        pat = "11" + "011" * k
        return Seed(pat, rank)
    if rank not in (0, 1, 2):
        raise ValueError(f"unknown seed rank {rank}")
    unit = {0: "110", 1: "1110", 2: "10"}[rank]
    if weight < 5:
        return Seed("1" * weight, rank)  # degenerate: too light to space
    if weight % 2 == 1:
        half = _half_from_unit(unit, (weight - 1) // 2)
        pat = half + "1" + half[::-1]
    else:
        half = _half_from_unit(unit, weight // 2)
        pat = half + "0" + half[::-1]
    return Seed(pat, rank)


def get_seed_length(weight: int, rank: int = 0) -> int:
    return get_seed(weight, rank).length


def seed_family(weight: int) -> list[Seed]:
    """The 3-member spaced seed family for a weight, longest pattern first
    (search order of src/progressiveMauve.cpp:511-517)."""
    fam = [get_seed(weight, r) for r in (0, 1, 2)]
    fam.sort(key=lambda s: -s.length)
    return fam


def default_seed_weight(avg_length: float) -> int:
    """Default spaced-seed weight from average sequence length.

    The reference derives this in libMems getDefaultSeedWeight; progressive
    aligners use a weight substantially below the solid default so spaced
    seeds retain sensitivity (~15 for bacterial genomes).  We use
    round(log2(avg)/1.5) clamped to the valid range.
    """
    if avg_length <= 2:
        return MIN_SEED_WEIGHT
    w = int(round(math.log2(avg_length) / 1.5))
    return max(MIN_SEED_WEIGHT + 2, min(MAX_SEED_WEIGHT, w))


def default_mer_size(avg_length: float) -> int:
    """mauveAligner's default: log_2(average sequence length)
    (usage text src/mauveAligner.cpp:878; MatchList::GetDefaultMerSize)."""
    if avg_length <= 2:
        return MIN_SEED_WEIGHT
    return max(MIN_SEED_WEIGHT, min(MAX_SEED_WEIGHT, int(round(math.log2(avg_length)))))
