"""K1 driver and the Sorted Mer List with its disk cache.

Port of mauvealigner_tpu/core/sml.py: build_mer_list_device (the sort-free
producer the multi-MUM search consumes), and the host SortedMerList
container with its disk cache, libMems DNAFileSML/FileSML in the reference
(src/mauveAligner.cpp:365, src/progressiveMauve.cpp:215-224).  Cache files
are named ``<seqfile>.<pattern>.sslist.npz`` after the reference's
``seq.<pattern>.sslist`` (getDefaultSmlFileNames,
src/progressiveMauve.cpp:215-224), in the JAX package's format, so each
package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.genome.sequence import CODE_N, Genome
from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.seeds import Seed

_SML_FORMAT_VERSION = 1

# scratch-path registry (FileSML::registerTempPath equivalent,
# src/mauveAligner.cpp:364-366); used when the sequence directory is
# read-only.
_temp_paths: list[str] = []


def register_temp_path(path: str) -> None:
    _temp_paths.append(path)


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


@dataclasses.dataclass
class SortedMerList:
    """Sorted canonical spaced-mer list for one genome."""

    keys: np.ndarray        # int64[n_valid], sorted canonical keys (strand in LSB)
    positions: np.ndarray   # int32[n_valid], 0-based window starts
    seed: Seed
    seq_length: int

    @property
    def seed_length(self) -> int:
        return self.seed.length

    @property
    def seed_weight(self) -> int:
        return self.seed.weight

    def unique_mer_count(self) -> int:
        return merops.unique_mer_count(self.keys, len(self.keys))

    def get_mer_at_sorted_index(self, i: int) -> int:
        return int(self.keys[i])


def build_sml(genome: Genome, seed: Seed, device="cuda") -> SortedMerList:
    """Run the sorted K1 pipeline for one genome on `device`; host arrays."""
    if len(genome) < seed.length:
        return SortedMerList(
            np.zeros(0, np.int64), np.zeros(0, np.int32), seed, len(genome)
        )
    codes = upload_codes(genome, seed.length, device)
    keys, pos, n = merops.build_sorted_mer_list(
        codes, tuple(int(o) for o in seed.offsets), seed.length
    )
    keys_np = keys[:n].cpu().numpy()
    pos_np = pos[:n].cpu().numpy()
    # windows past the real sequence end read the CODE_N tail, hence invalid
    assert len(keys_np) == 0 or pos_np.max() <= len(genome) - seed.length
    return SortedMerList(keys_np, pos_np, seed, len(genome))


def _cache_path(seq_filename: str, seed: Seed) -> str:
    return f"{seq_filename}.{seed.pattern}.sslist.npz"


def load_sml(
    genome: Genome, seed: Seed, cache: bool = True, cache_path: Optional[str] = None,
    device="cuda",
) -> SortedMerList:
    """Load an SML from the disk cache, building (and caching) on miss —
    MatchList::LoadSMLs semantics (src/progressiveMauve.cpp:447-451)."""
    path = cache_path or (_cache_path(genome.filename, seed) if genome.filename else None)
    if cache and path:
        # the save fallback may have written to a registered scratch path
        # (read-only sequence directory): check those on load too
        candidates = [path] + [
            os.path.join(tp, os.path.basename(path)) for tp in _temp_paths
        ]
        for cand in candidates:
            if not os.path.exists(cand):
                continue
            try:
                with np.load(cand) as z:
                    if (
                        int(z["version"]) == _SML_FORMAT_VERSION
                        and str(z["pattern"]) == seed.pattern
                        and int(z["seq_length"]) == len(genome)
                    ):
                        return SortedMerList(z["keys"], z["positions"], seed, len(genome))
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # unreadable or stale cache: rebuild
    sml = build_sml(genome, seed, device)
    if cache and path:
        for candidate_dir in [os.path.dirname(path) or "."] + _temp_paths:
            try:
                np.savez(
                    os.path.join(candidate_dir, os.path.basename(path)),
                    version=_SML_FORMAT_VERSION,
                    pattern=seed.pattern,
                    seq_length=len(genome),
                    keys=sml.keys,
                    positions=sml.positions,
                )
                break
            except OSError:
                continue
    return sml
