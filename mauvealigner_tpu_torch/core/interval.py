"""L3: gapped alignment intervals (LCBs) and the IntervalList container.

Equivalent of libMems Interval/IntervalList/GappedAlignment/
CompactGappedAlignment (reference use at src/mauveAligner.cpp:692-781 and 33
other files).  An Interval here is a *flattened* LCB: instead of a chain of
match + gapped-fill objects it stores the final column structure directly:

  * starts[j]  — signed 1-based leftmost coordinate in sequence j (0=absent);
  * aln[j, c]  — True where column c has a base from sequence j (False=gap).

Column text is materialized only during serialization, from the genome plus
the boolean gap structure (the reference's CompactGappedAlignment makes the
same trade: bit-compressed columns, src/repeatoire.cpp:1316-1319).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Genome


@dataclasses.dataclass
class Interval:
    starts: np.ndarray  # int64 [n_seqs], signed, 0 = absent
    aln: np.ndarray     # bool [n_seqs, n_cols]

    def __post_init__(self):
        self.starts = np.asarray(self.starts, dtype=np.int64)
        self.aln = np.asarray(self.aln, dtype=bool)

    @classmethod
    def _unchecked(cls, starts: np.ndarray, aln: np.ndarray) -> "Interval":
        """Construct without the __post_init__ dtype coercion — for bulk
        emitters that already guarantee int64 starts / bool aln (the two
        asarray calls cost ~1 s over the headline's ~600k backbone
        intervals)."""
        iv = cls.__new__(cls)
        iv.starts = starts
        iv.aln = aln
        return iv

    @property
    def n_seqs(self) -> int:
        return len(self.starts)

    @property
    def n_cols(self) -> int:
        return self.aln.shape[1]

    def seq_lengths(self) -> np.ndarray:
        """Number of (non-gap) bases per sequence."""
        return self.aln.sum(axis=1).astype(np.int64)

    def lefts(self) -> np.ndarray:
        return np.abs(self.starts)

    def rights(self) -> np.ndarray:
        lens = self.seq_lengths()
        l = self.lefts()
        return np.where(l > 0, l + lens - 1, 0)

    def multiplicity(self) -> int:
        return int((self.starts != 0).sum())

    def aligned_text(self, genomes: Sequence[Genome], seq: int) -> str:
        """Gapped alignment row for one sequence (revcomp for negative)."""
        if self.starts[seq] == 0:
            return "-" * self.n_cols
        length = int(self.aln[seq].sum())
        bases = genomes[seq].subseq_signed(int(self.starts[seq]), length)
        out = np.full(self.n_cols, ord("-"), dtype=np.uint8)
        out[self.aln[seq]] = np.frombuffer(bases.encode(), np.uint8)
        return out.tobytes().decode("ascii")

    def strip_gap_columns(self) -> "Interval":
        """Drop all-gap columns (stripGapColumns tool semantics)."""
        keep = self.aln.any(axis=0)
        return Interval(self.starts.copy(), self.aln[:, keep])

    def column_slice(self, a: int, b: int) -> "Interval":
        """Sub-interval over columns [a, b) with starts recomputed
        (CropStart/CropEnd semantics, reference call site
        src/stripSubsetLCBs.cpp:130-131)."""
        aln = self.aln[:, a:b].copy()
        starts = np.zeros(self.n_seqs, np.int64)
        for s in range(self.n_seqs):
            st = int(self.starts[s])
            if st == 0 or not aln[s].any():
                continue
            n_before = int(self.aln[s, :a].sum())
            n_in = int(aln[s].sum())
            if st > 0:
                starts[s] = st + n_before
            else:
                # reverse: alignment-left columns hold the genome-rightmost
                # bases, so skipping n_before columns drops from the right
                length = int(self.aln[s].sum())
                starts[s] = -(abs(st) + length - n_before - n_in)
        return Interval(starts, aln)

    def column_to_position(self, seq: int, col: int) -> int:
        """Alignment column -> signed 1-based sequence position (0 if gap).

        coordinateTranslate tool semantics (src/coordinateTranslate.cpp:16).
        """
        if self.starts[seq] == 0 or not self.aln[seq, col]:
            return 0
        n_before = int(self.aln[seq, : col + 1].sum())  # rank of this base
        s = int(self.starts[seq])
        length = int(self.aln[seq].sum())
        if s > 0:
            return s + n_before - 1
        # reverse strand: column order walks right-to-left on forward strand
        return -(abs(s) + length - n_before)

    def position_to_column(self, seq: int, pos: int) -> int:
        """1-based forward-strand position -> alignment column (-1 if outside)."""
        s = int(self.starts[seq])
        if s == 0:
            return -1
        length = int(self.aln[seq].sum())
        left = abs(s)
        if not (left <= pos <= left + length - 1):
            return -1
        rank = pos - left + 1 if s > 0 else (left + length - pos)
        cols = np.nonzero(self.aln[seq])[0]
        return int(cols[rank - 1])


@dataclasses.dataclass
class IntervalList:
    """An alignment: a set of Intervals over common sequences."""

    genomes: List[Genome]
    intervals: List[Interval]
    seq_filenames: List[str] = dataclasses.field(default_factory=list)
    backbone_filename: str = ""

    @property
    def n_seqs(self) -> int:
        return len(self.genomes)

    def filenames(self) -> List[str]:
        if self.seq_filenames:
            return self.seq_filenames
        return [g.filename or g.name or f"seq{i}" for i, g in enumerate(self.genomes)]

    # ------------------------------------------------------------------
    # XMFA (eXtended Multi-FastA) serialization: WriteStandardAlignment /
    # ReadStandardAlignment equivalents (src/mauveAligner.cpp:702,750).
    # ------------------------------------------------------------------
    def write_xmfa(self, out: Union[str, TextIO], width: int = 80) -> None:
        if isinstance(out, str):
            with open(out, "w") as fh:
                self.write_xmfa(fh, width=width)
                return
        fh = out
        names = self.filenames()
        fh.write("#FormatVersion Mauve1\n")
        for i, g in enumerate(self.genomes):
            fh.write(f"#Sequence{i + 1}File\t{names[i]}\n")
            fh.write(f"#Sequence{i + 1}Entry\t{i + 1}\n")
            fh.write(f"#Sequence{i + 1}Format\tFastA\n")
        if self.backbone_filename:
            fh.write(f"#BackboneFile\t{self.backbone_filename}\n")
        for iv in self.intervals:
            lefts, rights = iv.lefts(), iv.rights()
            for seq in range(iv.n_seqs):
                if iv.starts[seq] == 0:
                    fh.write(f"> {seq + 1}:0-0 + {names[seq]}\n")
                    text = "-" * iv.n_cols
                else:
                    strand = "+" if iv.starts[seq] > 0 else "-"
                    fh.write(f"> {seq + 1}:{lefts[seq]}-{rights[seq]} {strand} {names[seq]}\n")
                    text = iv.aligned_text(self.genomes, seq)
                for c in range(0, len(text), width):
                    fh.write(text[c : c + width])
                    fh.write("\n")
            fh.write("=\n")

    @classmethod
    def read_xmfa(
        cls, src: Union[str, TextIO], genomes: Optional[List[Genome]] = None
    ) -> "IntervalList":
        if isinstance(src, str):
            with open(src) as fh:
                return cls.read_xmfa(fh, genomes=genomes)
        fh = src
        seq_files: dict = {}
        intervals: List[Interval] = []
        cur_entries: List[Tuple[int, int, int, str]] = []  # (seq idx0, start signed, text)
        cur_texts: List[str] = []
        cur_seq: Optional[Tuple[int, int, str]] = None
        header_re = re.compile(r">\s*(\d+):(\d+)-(\d+)\s+([+-])(?:\s+(.*))?")
        max_seq = 0

        def flush_entry():
            nonlocal cur_seq, cur_texts
            if cur_seq is not None:
                idx, signed_start, _ = cur_seq
                cur_entries.append((idx, signed_start, 0, "".join(cur_texts)))
            cur_seq = None
            cur_texts = []

        def flush_block():
            nonlocal cur_entries
            flush_entry()
            if cur_entries:
                n = max(e[0] for e in cur_entries) + 1
                ncols = max((len(e[3]) for e in cur_entries), default=0)
                starts = np.zeros(max(n, max_seq), np.int64)
                aln = np.zeros((max(n, max_seq), ncols), bool)
                for idx, signed_start, _, text in cur_entries:
                    starts[idx] = signed_start
                    row = np.frombuffer(text.ljust(ncols, "-").encode(), np.uint8)
                    aln[idx] = row != ord("-")
                intervals.append(Interval(starts, aln))
            cur_entries = []

        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                m = re.match(r"#Sequence(\d+)File\s+(.*)", line)
                if m:
                    seq_files[int(m.group(1)) - 1] = m.group(2).strip()
                    max_seq = max(max_seq, int(m.group(1)))
                continue
            if line.startswith("="):
                flush_block()
                continue
            if line.startswith(">"):
                flush_entry()
                m = header_re.match(line)
                if not m:
                    raise ValueError(f"bad XMFA header line: {line!r}")
                idx = int(m.group(1)) - 1
                left, right = int(m.group(2)), int(m.group(3))
                strand = 1 if m.group(4) == "+" else -1
                max_seq = max(max_seq, idx + 1)
                signed = 0 if (left == 0 and right == 0) else strand * left
                cur_seq = (idx, signed, m.group(5) or "")
                continue
            if cur_seq is not None:
                cur_texts.append(line.strip())
        flush_block()

        n_seqs = max(max_seq, max((iv.n_seqs for iv in intervals), default=0))
        # normalize interval widths
        fixed = []
        for iv in intervals:
            if iv.n_seqs < n_seqs:
                starts = np.zeros(n_seqs, np.int64)
                starts[: iv.n_seqs] = iv.starts
                aln = np.zeros((n_seqs, iv.n_cols), bool)
                aln[: iv.n_seqs] = iv.aln
                iv = Interval(starts, aln)
            fixed.append(iv)
        gs = genomes or [Genome.from_string("") for _ in range(n_seqs)]
        names = [seq_files.get(i, "") for i in range(n_seqs)]
        return cls(genomes=gs, intervals=fixed, seq_filenames=names)

    # ------------------------------------------------------------------
    def add_unaligned_intervals(self) -> None:
        """Add single-sequence intervals covering unaligned regions
        (addUnalignedIntervals, libMems fn; call site src/mauveAligner.cpp:748).

        Per-interval row lengths are computed ONCE for all sequences (the
        per-seq loop re-scanned every interval's whole aln n_seqs times),
        and the emitted single-seq intervals share one all-True-row block
        per sequence (nothing mutates aln in place pipeline-wide)."""
        n = self.n_seqs
        ivs = list(self.intervals)
        all_starts = (
            np.stack([iv.starts for iv in ivs]) if ivs else np.zeros((0, n))
        )
        all_lens = (
            np.stack([iv.seq_lengths() for iv in ivs])
            if ivs
            else np.zeros((0, n), np.int64)
        )
        for seq in range(n):
            glen = len(self.genomes[seq])
            covered = np.zeros(glen + 2, dtype=np.int64)
            if len(ivs):
                pres = all_starts[:, seq] != 0
                l = np.abs(all_starts[pres, seq]).astype(np.int64)
                r = l + all_lens[pres, seq] - 1
                np.add.at(covered, l, 1)
                np.add.at(covered, r + 1, -1)
            cov = np.cumsum(covered[: glen + 1])
            free = cov[1:] == 0  # positions 1..glen
            if not free.any():
                continue
            d = np.diff(np.concatenate([[0], free.view(np.int8), [0]]))
            starts_ = np.nonzero(d == 1)[0] + 1
            ends_ = np.nonzero(d == -1)[0]
            if not len(starts_):
                continue
            widths = ends_ - starts_ + 1
            st_mat = np.zeros((len(starts_), n), np.int64)
            st_mat[:, seq] = starts_
            block = np.zeros((n, int(widths.max())), bool)
            block[seq] = True
            mk = Interval._unchecked
            for i, w in enumerate(widths.tolist()):
                self.intervals.append(mk(st_mat[i], block[:, :w]))

    def projection(self, seq_indices: Sequence[int], min_cols: int = 1) -> "IntervalList":
        """Project the alignment onto a subset of sequences
        (alignmentProjector semantics, src/alignmentProjector.cpp:30)."""
        idx = list(seq_indices)
        new_ivs = []
        for iv in self.intervals:
            starts = iv.starts[idx]
            if (starts != 0).sum() == 0:
                continue
            aln = iv.aln[idx]
            keep = aln.any(axis=0)
            if keep.sum() < min_cols:
                continue
            new_ivs.append(Interval(starts.copy(), aln[:, keep]))
        return IntervalList(
            genomes=[self.genomes[i] for i in idx],
            intervals=new_ivs,
            seq_filenames=[self.filenames()[i] for i in idx],
        )
