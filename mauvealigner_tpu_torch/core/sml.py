"""K1 driver: a genome's spaced-mer list on the device.

Port of build_mer_list_device from mauvealigner_tpu/core/sml.py (the
sort-free producer the multi-MUM search consumes).  The host SortedMerList
container and its disk cache are not part of this slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mauvealigner_tpu_torch.genome.sequence import CODE_N, Genome
from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.seeds import Seed


def upload_codes(genome: Genome, pattern_len: int, device) -> torch.Tensor:
    """Genome codes as a uint8 device tensor with pattern_len CODE_N cells
    appended, so every genome (even one shorter than the seed) yields at
    least one, invalid, window."""
    codes = torch.from_numpy(genome.codes).to(device)
    tail = torch.full((pattern_len,), CODE_N, dtype=torch.uint8, device=codes.device)
    return torch.cat([codes, tail])


def build_mer_list_device(
    genome: Genome, seed: Seed, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys int64, positions int32) device tensors, unsorted, INVALID
    interspersed, for find_multi_mums_device."""
    from mauvealigner_tpu_torch.utils import timing

    timing.GLOBAL.add("k1_bases", float(len(genome)))
    codes = upload_codes(genome, seed.length, device)
    return merops.build_mer_list(
        codes, tuple(int(o) for o in seed.offsets), seed.length
    )
