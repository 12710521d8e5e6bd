"""L3: ungapped match data model as struct-of-arrays.

Equivalent of the libMems Match/AbstractMatch family
(src/MatchRecord.h:4-10, src/progressiveMauve.cpp:125-139) re-designed for
array programming: a MatchList is a pair of dense arrays instead of a vector
of pointer-linked objects.

Coordinate convention (identical to the reference's):
  * starts[i, j] is a signed 1-based coordinate of match i in sequence j;
  * 0 (NO_MATCH) means sequence j does not participate;
  * |start| is the LEFTMOST coordinate of the matching region on the forward
    strand; negative sign means the match aligns to the reverse complement;
  * lengths[i] is the number of columns (matches are ungapped: every
    participating sequence spans exactly `length` bases).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

NO_MATCH = 0


@dataclasses.dataclass
class MatchList:
    """Dense ungapped match table over n_seqs sequences."""

    starts: np.ndarray   # int64 [n, n_seqs], signed, 0 = NO_MATCH
    lengths: np.ndarray  # int64 [n]

    def __post_init__(self):
        self.starts = np.asarray(self.starts, dtype=np.int64)
        self.lengths = np.asarray(self.lengths, dtype=np.int64)
        if self.starts.ndim != 2 or len(self.lengths) != len(self.starts):
            raise ValueError("inconsistent MatchList arrays")

    # -- basics -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.lengths)

    @property
    def n_seqs(self) -> int:
        return self.starts.shape[1]

    @classmethod
    def empty(cls, n_seqs: int) -> "MatchList":
        return cls(np.zeros((0, n_seqs), np.int64), np.zeros(0, np.int64))

    def multiplicity(self) -> np.ndarray:
        return (self.starts != NO_MATCH).sum(axis=1)

    def lefts(self) -> np.ndarray:
        """|start| with 0 for NO_MATCH."""
        return np.abs(self.starts)

    def rights(self) -> np.ndarray:
        """1-based inclusive right end per component (0 for NO_MATCH)."""
        l = self.lefts()
        return np.where(l > 0, l + self.lengths[:, None] - 1, 0)

    def select(self, row_mask_or_idx) -> "MatchList":
        return MatchList(self.starts[row_mask_or_idx], self.lengths[row_mask_or_idx])

    def concat(self, other: "MatchList") -> "MatchList":
        return MatchList(
            np.concatenate([self.starts, other.starts]),
            np.concatenate([self.lengths, other.lengths]),
        )

    # -- reference-parity operations ---------------------------------------
    def multiplicity_filter(self, n_way: int) -> "MatchList":
        """Keep only matches present in exactly/at-least n_way sequences
        (MultiplicityFilter, src/mauveAligner.cpp:600-607)."""
        return self.select(self.multiplicity() >= n_way)

    def invert(self) -> "MatchList":
        """Flip strand of every component (AbstractMatch::Invert)."""
        return MatchList(-self.starts, self.lengths.copy())

    def crop_left(self, amount: np.ndarray) -> "MatchList":
        """Remove `amount` columns from the left (match-space) end.

        AbstractMatch::CropLeft semantics (src/MatchRecord.h:262-276): for
        forward components the left coordinate advances; for reverse
        components match-space left is the genome RIGHT end, so |start| is
        unchanged.
        """
        amount = np.asarray(amount, dtype=np.int64)
        starts = self.starts.copy()
        fwd = starts > 0
        starts[fwd] = starts[fwd] + np.broadcast_to(amount[:, None], starts.shape)[fwd]
        return MatchList(starts, self.lengths - amount)

    def crop_right(self, amount: np.ndarray) -> "MatchList":
        """Remove `amount` columns from the right (match-space) end."""
        amount = np.asarray(amount, dtype=np.int64)
        starts = self.starts.copy()
        rev = starts < 0
        starts[rev] = starts[rev] - np.broadcast_to(amount[:, None], starts.shape)[rev]
        return MatchList(starts, self.lengths - amount)

    def sort_by_sequence(self, seq: int) -> "MatchList":
        """Order matches along sequence `seq` (absent components last)."""
        key = np.abs(self.starts[:, seq]).astype(np.int64)
        key[self.starts[:, seq] == NO_MATCH] = np.iinfo(np.int64).max
        order = np.argsort(key, kind="stable")
        return self.select(order)

    def dedup(self) -> "MatchList":
        """Remove exactly-identical matches (first occurrence wins, original
        order preserved — np.unique(axis=0) semantics via a stable lexsort,
        which avoids unique's void-view row copies: ~10x on 100k-row lists)."""
        if len(self) == 0:
            return self
        rows = np.concatenate([self.starts, self.lengths[:, None]], axis=1)
        order = np.lexsort(rows.T[::-1])
        sr = rows[order]
        first = np.ones(len(sr), bool)
        first[1:] = (sr[1:] != sr[:-1]).any(axis=1)
        return self.select(np.sort(order[first]))

    def project(self, seq_indices: Sequence[int]) -> "MatchList":
        """Restrict to a subset of sequences, dropping matches that lose
        multiplicity<2 (MatchProjectionAdapter, src/MatchRecord.h:242)."""
        sub = MatchList(self.starts[:, list(seq_indices)], self.lengths.copy())
        return sub.select(sub.multiplicity() >= 2)

    def eliminate_overlaps(self) -> "MatchList":
        """Resolve pairwise overlaps between matches within each sequence by
        cropping the lower-multiplicity (then shorter) match — semantics of
        libMems EliminateOverlaps_v2 (call site src/mauveAligner.cpp:596).

        Iterates per sequence: sorts matches by left coordinate and crops any
        overlap with the previous interval.  Matches cropped to length <=0
        are removed.

        Rows are first put in CANONICAL order (|start| per sequence, then
        length, then signed starts): the per-sequence stable sorts break
        |left| ties by row order, so without canonicalization the crop
        cascade would depend on upstream pipeline ordering — the C++ column
        oracle (native/reference_pipeline.cpp) sorts identically, making the
        cascade implementation-independent.
        """
        if len(self) > 1:
            keys = [self.starts[:, g] for g in range(self.n_seqs - 1, -1, -1)]
            keys.insert(0, self.lengths)
            abs_keys = [np.abs(self.starts[:, g]) for g in range(self.n_seqs - 1, -1, -1)]
            order = np.lexsort(tuple(keys) + tuple(abs_keys))
            self = self.select(order)
        # native host runtime fast path (bit-identical; native/mauve_native.cpp)
        from mauvealigner_tpu_torch import native

        mod = native.get()
        if mod is not None and hasattr(mod, "eliminate_overlaps") and len(self):
            n, n_seqs = self.starts.shape
            s_out, l_out = mod.eliminate_overlaps(
                np.ascontiguousarray(self.starts, dtype=np.int64).tobytes(),
                np.ascontiguousarray(self.lengths, dtype=np.int64).tobytes(),
                n,
                n_seqs,
            )
            starts = np.frombuffer(s_out, np.int64).reshape(n, n_seqs)
            lengths = np.frombuffer(l_out, np.int64)
            keep = lengths > 0
            out = MatchList(starts[keep].copy(), lengths[keep].copy())
            return out.select(out.multiplicity() >= 1)
        ml = MatchList(self.starts.copy(), self.lengths.copy())
        changed = True
        iters = 0
        while changed and iters < 8:
            changed = False
            iters += 1
            mult = ml.multiplicity()
            for seq in range(ml.n_seqs):
                comp = ml.starts[:, seq]
                idx = np.nonzero(comp != NO_MATCH)[0]
                if len(idx) < 2:
                    continue
                order = idx[np.argsort(np.abs(comp[idx]), kind="stable")]
                prev = order[0]
                for cur in order[1:]:
                    prev_r = abs(ml.starts[prev, seq]) + ml.lengths[prev] - 1
                    cur_l = abs(ml.starts[cur, seq])
                    if cur_l <= prev_r and ml.lengths[cur] > 0 and ml.lengths[prev] > 0:
                        overlap = int(prev_r - cur_l + 1)
                        # crop the weaker match: lower multiplicity, then shorter
                        victim_is_cur = not (
                            (mult[prev], ml.lengths[prev]) < (mult[cur], ml.lengths[cur])
                        )
                        victim = cur if victim_is_cur else prev
                        amt = min(overlap, int(ml.lengths[victim]))
                        # overlap touches `cur`'s genome-LEFT edge and `prev`'s
                        # genome-RIGHT edge; genome-left is match-space left
                        # for forward components and match-space right for
                        # reverse ones
                        overlap_on_genome_left = victim_is_cur
                        forward = ml.starts[victim, seq] > 0
                        if overlap_on_genome_left == forward:
                            _crop_row_left(ml, victim, amt)
                        else:
                            _crop_row_right(ml, victim, amt)
                        changed = True
                    cur_r = abs(ml.starts[cur, seq]) + ml.lengths[cur] - 1
                    prev_r = abs(ml.starts[prev, seq]) + ml.lengths[prev] - 1
                    if cur_r > prev_r or ml.lengths[prev] <= 0:
                        prev = cur
            keep = ml.lengths > 0
            if not keep.all():
                ml = ml.select(keep)
        return ml.select(ml.multiplicity() >= 1)

    def __repr__(self) -> str:
        return f"MatchList(n={len(self)}, n_seqs={self.n_seqs})"


def _crop_row_left(ml: MatchList, row: int, amount: int) -> None:
    fwd = ml.starts[row] > 0
    ml.starts[row, fwd] += amount
    ml.lengths[row] -= amount


def _crop_row_right(ml: MatchList, row: int, amount: int) -> None:
    rev = ml.starts[row] < 0
    ml.starts[row, rev] -= amount
    ml.lengths[row] -= amount
