"""Genome & contig model with 2-bit encoding for device kernels.

TPU-native counterpart of libGenome's gnSequence (used at
reference src/mauveAligner.cpp:17, src/sortContigs.cpp:87-119).

Design: a Genome owns
  * ``seq`` — the raw ASCII bytes of the concatenated contigs (numpy uint8),
    preserved verbatim for faithful output;
  * ``codes`` — per-base 2-bit codes (A=0, C=1, G=2, T=3; anything else
    CODE_N=4), the array shipped to HBM for mer packing / DP kernels;
  * ``contigs`` — contig name/length/offset records for global<->local
    coordinate mapping (gnSequence::globalToLocal equivalent).

All user-facing coordinates are 1-based inclusive, matching the reference's
match/interval conventions (negative start = reverse strand).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4

# ASCII -> 2-bit code (case-insensitive); every non-ACGT letter maps to CODE_N.
_ENCODE_LUT = np.full(256, CODE_N, dtype=np.uint8)
for _ch, _code in (("A", CODE_A), ("C", CODE_C), ("G", CODE_G), ("T", CODE_T)):
    _ENCODE_LUT[ord(_ch)] = _code
    _ENCODE_LUT[ord(_ch.lower())] = _code

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# IUPAC-complete ASCII complement table (gnFilter revcomp equivalent,
# reference use at src/repeatoire.cpp:1236).
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"), ("U", "A"),
    ("R", "Y"), ("Y", "R"), ("K", "M"), ("M", "K"),
    ("B", "V"), ("V", "B"), ("D", "H"), ("H", "D"),
]:
    _COMP_LUT[ord(_a)] = ord(_b)
    _COMP_LUT[ord(_a.lower())] = ord(_b.lower())


def encode_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 array -> 2-bit codes (CODE_N for ambiguity)."""
    return _ENCODE_LUT[seq_bytes]


def decode_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> ASCII uint8 ('N' for CODE_N)."""
    return _DECODE_LUT[np.minimum(codes, CODE_N)]


def revcomp_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    return _COMP_LUT[seq_bytes[::-1]]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


@dataclasses.dataclass
class Contig:
    name: str
    length: int
    offset: int  # 0-based offset into the concatenated genome


@dataclasses.dataclass
class Feature:
    """Minimal annotation record (gnBaseFeature/gnLocation equivalent,
    reference use at src/getOrthologList.cpp:115-120)."""

    kind: str              # e.g. "CDS", "gene"
    start: int             # 1-based inclusive, global coords
    end: int               # 1-based inclusive
    strand: int            # +1 / -1
    qualifiers: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        for key in ("gene", "locus_tag", "product"):
            if key in self.qualifiers:
                return self.qualifiers[key]
        return f"{self.kind}:{self.start}-{self.end}"


class Genome:
    """A (possibly multi-contig) genome held as concatenated sequence."""

    def __init__(
        self,
        seq: np.ndarray,
        contigs: Optional[List[Contig]] = None,
        name: str = "",
        filename: str = "",
        features: Optional[List[Feature]] = None,
    ):
        seq = np.asarray(seq, dtype=np.uint8)
        self.seq = seq
        self.codes = encode_ascii(seq)
        self.contigs = contigs or [Contig(name or "seq0", len(seq), 0)]
        self.name = name or (self.contigs[0].name if self.contigs else "")
        self.filename = filename
        self.features = features or []

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_string(cls, s: str, name: str = "seq0", **kw) -> "Genome":
        return cls(np.frombuffer(s.encode(), dtype=np.uint8), name=name, **kw)

    @classmethod
    def from_codes(cls, codes: np.ndarray, name: str = "seq0", **kw) -> "Genome":
        return cls(decode_codes(np.asarray(codes, dtype=np.int64)), name=name, **kw)

    # -- basics -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.seq)

    @property
    def length(self) -> int:
        return len(self.seq)

    def to_string(self) -> str:
        return self.seq.tobytes().decode("ascii", errors="replace")

    # -- subsequence extraction (1-based inclusive; negative left = revcomp) -
    def subseq(self, left: int, right: int) -> str:
        """Forward-strand subsequence, 1-based inclusive coordinates."""
        if left < 1 or right > len(self.seq) or left > right + 1:
            raise IndexError(f"subseq({left},{right}) out of range 1..{len(self.seq)}")
        return self.seq[left - 1 : right].tobytes().decode("ascii")

    def subseq_signed(self, start: int, length: int) -> str:
        """Mauve-style signed extraction: |start| = leftmost 1-based coord of
        the region; negative start returns the reverse complement."""
        left = abs(start)
        chunk = self.seq[left - 1 : left - 1 + length]
        if start < 0:
            chunk = revcomp_ascii(chunk)
        return chunk.tobytes().decode("ascii")

    def sub_codes_signed(self, start: int, length: int) -> np.ndarray:
        left = abs(start)
        chunk = self.codes[left - 1 : left - 1 + length]
        if start < 0:
            chunk = revcomp_codes(chunk)
        return chunk

    # -- coordinates --------------------------------------------------------
    def global_to_local(self, pos: int) -> Tuple[int, int]:
        """1-based global position -> (contig_index, 1-based local position)."""
        if pos < 1 or pos > len(self.seq):
            raise IndexError(f"position {pos} out of range")
        offs = np.array([c.offset for c in self.contigs])
        idx = int(np.searchsorted(offs, pos - 1, side="right")) - 1
        return idx, pos - self.contigs[idx].offset

    def local_to_global(self, contig_index: int, local_pos: int) -> int:
        c = self.contigs[contig_index]
        if local_pos < 1 or local_pos > c.length:
            raise IndexError(f"local position {local_pos} out of contig range")
        return c.offset + local_pos

    def contig_boundaries(self) -> np.ndarray:
        """1-based global start coordinate of every contig."""
        return np.array([c.offset + 1 for c in self.contigs], dtype=np.int64)

    # -- N-run masking with coordinate transposition -------------------------
    # Reference semantics: sequences may be pre-masked to remove long N runs;
    # matches found on the masked sequence are transposed back to original
    # coordinates (transposeMatches, src/mauveAligner.cpp:629-637;
    # src/transposeCoordinates.cpp).
    def mask_n_runs(self, min_run: int = 10) -> Tuple["Genome", np.ndarray]:
        """Remove runs of >=min_run ambiguity codes.

        Returns (masked_genome, removed_regions) where removed_regions is an
        (R, 2) int64 array of [start, length] pairs in *original* 1-based
        coordinates, the format consumed by transpose_positions().
        """
        is_n = self.codes == CODE_N
        if not is_n.any():
            return self, np.zeros((0, 2), dtype=np.int64)
        # run-length encode the N mask
        d = np.diff(np.concatenate([[0], is_n.view(np.int8), [0]]))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        keep_runs = (ends - starts) >= min_run
        starts, ends = starts[keep_runs], ends[keep_runs]
        if len(starts) == 0:
            return self, np.zeros((0, 2), dtype=np.int64)
        drop = np.zeros(len(self.seq), dtype=bool)
        for s, e in zip(starts, ends):
            drop[s:e] = True
        masked = Genome(
            self.seq[~drop],
            contigs=None,
            name=self.name,
            filename=self.filename,
        )
        regions = np.stack([starts + 1, ends - starts], axis=1).astype(np.int64)
        return masked, regions

    def __repr__(self) -> str:
        return f"Genome({self.name!r}, len={len(self.seq)}, contigs={len(self.contigs)})"


def transpose_positions(signed_pos: np.ndarray, lengths: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Transpose signed 1-based match positions from masked coordinates back to
    original coordinates given removed [start,length] regions.

    Equivalent of libMems transposeMatches (reference call site
    src/mauveAligner.cpp:629-637): every removed region that lies at or before
    a match's left end shifts that match right by the region's length.
    """
    if len(regions) == 0:
        return signed_pos
    out = np.array(signed_pos, dtype=np.int64, copy=True)
    order = np.argsort(regions[:, 0])
    reg_starts = regions[order, 0]
    reg_lens = regions[order, 1]
    cum = np.cumsum(reg_lens)
    # masked coordinate of each region start: original start minus total
    # removed before it
    masked_starts = reg_starts - np.concatenate([[0], cum[:-1]])
    mask = out != 0
    lefts = np.abs(out[mask])
    shift_idx = np.searchsorted(masked_starts, lefts, side="right")
    shifts = np.where(shift_idx > 0, cum[np.maximum(shift_idx - 1, 0)], 0)
    out[mask] = np.sign(out[mask]) * (lefts + shifts)
    return out
