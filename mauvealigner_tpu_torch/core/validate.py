"""Internal consistency checks (debug builds).

Equivalent of the reference's debug-mode validation: `--debug` sets
"perform internal consistency checks--very slow"
(src/progressiveMauve.cpp:281,580-581) and repeatoire's validate() walks
every record asserting invariants (src/repeatoire.cpp:446-521).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from mauvealigner_tpu_torch.core.interval import IntervalList
from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList
from mauvealigner_tpu_torch.genome.sequence import Genome


class ConsistencyError(AssertionError):
    pass


def validate_match_list(
    ml: MatchList,
    genomes: Sequence[Genome],
    check_bases: bool = True,
    max_mismatch_fraction: float = 0.2,
) -> None:
    """Assert coordinate sanity and that every match's columns agree across
    its components.

    Spaced-seed anchors legitimately contain mismatches at seed don't-care
    positions (that is the point of spaced seeds), so base agreement is
    checked against a tolerance: the mismatch fraction must stay below the
    seed's don't-care density.  Pass 0.0 for solid-seed exactness.
    """
    if (ml.lengths <= 0).any():
        raise ConsistencyError("non-positive match length")
    for g in range(ml.n_seqs):
        comp = ml.starts[:, g]
        present = comp != NO_MATCH
        lefts = np.abs(comp[present])
        rights = lefts + ml.lengths[present] - 1
        if present.any() and (lefts < 1).any():
            raise ConsistencyError(f"seq {g}: match start < 1")
        if present.any() and (rights > len(genomes[g])).any():
            raise ConsistencyError(f"seq {g}: match end beyond sequence")
    if (ml.multiplicity() < 1).any():
        raise ConsistencyError("match with no components")
    if check_bases:
        for i in range(len(ml)):
            ref_cols = None
            for g in range(ml.n_seqs):
                s = int(ml.starts[i, g])
                if s == NO_MATCH:
                    continue
                cols = genomes[g].sub_codes_signed(s, int(ml.lengths[i]))
                if ref_cols is None:
                    ref_cols = cols
                    continue
                mism = int(np.count_nonzero(ref_cols != cols))
                allowed = int(max_mismatch_fraction * int(ml.lengths[i]))
                if mism > allowed:
                    raise ConsistencyError(
                        f"match {i}: component {g} disagrees on {mism}/"
                        f"{int(ml.lengths[i])} columns (allowed {allowed})"
                    )


def validate_interval_list(
    ivs: IntervalList, genomes: Sequence[Genome], require_full_coverage: bool = False
) -> None:
    """Assert every interval's rows are consistent and intervals do not
    doubly cover any base; optionally require complete genome coverage."""
    n = ivs.n_seqs
    for k, iv in enumerate(ivs.intervals):
        lens = iv.seq_lengths()
        for s in range(n):
            if iv.starts[s] == 0:
                if lens[s] != 0:
                    raise ConsistencyError(f"interval {k}: absent seq {s} has bases")
                continue
            if lens[s] == 0:
                raise ConsistencyError(f"interval {k}: present seq {s} has no bases")
            left = abs(int(iv.starts[s]))
            if left < 1 or left + int(lens[s]) - 1 > len(genomes[s]):
                raise ConsistencyError(f"interval {k}: seq {s} out of bounds")
    for s in range(n):
        cover = np.zeros(len(genomes[s]) + 2, np.int64)
        for iv in ivs.intervals:
            if iv.starts[s] == 0:
                continue
            l = abs(int(iv.starts[s]))
            r = l + int(iv.aln[s].sum()) - 1
            cover[l] += 1
            cover[r + 1] -= 1
        c = np.cumsum(cover[: len(genomes[s]) + 1])
        if (c > 1).any():
            raise ConsistencyError(f"seq {s}: doubly covered positions")
        if require_full_coverage and len(genomes[s]) and (c[1:] == 0).any():
            raise ConsistencyError(f"seq {s}: uncovered positions")
