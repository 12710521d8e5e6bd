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

from mauvealigner_tpu_torch.genome.sequence import Genome, complement_ascii, revcomp_ascii
from mauvealigner_tpu_torch.utils import timing

# The XMFA writer assembles runs of blocks at most _BATCH_MAX_COLS columns
# wide in chunks of about _BATCH_BYTES of text and headers: a fixed number of
# NumPy passes and one write a chunk, some 30 ns a cell and 1.5 us a row.  A
# wider block is written row by row, some 8 ns a cell and 17 us a row; the
# two cost the same near 512 columns.
_BATCH_MAX_COLS = 512
_BATCH_BYTES = 1 << 22


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
        return self.aligned_bytes(genomes, seq).tobytes().decode("ascii")

    def aligned_bytes(self, genomes: Sequence[Genome], seq: int) -> np.ndarray:
        """aligned_text as ASCII uint8."""
        out = np.full(self.n_cols, ord("-"), dtype=np.uint8)
        start = int(self.starts[seq])
        if start == 0:
            return out
        left = abs(start)
        bases = genomes[seq].seq[left - 1 : left - 1 + int(self.aln[seq].sum())]
        out[self.aln[seq]] = revcomp_ascii(bases) if start < 0 else bases
        return out

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
        if width < 1:
            raise ValueError(f"XMFA line width {width} is below 1")
        fh = out
        names = self.filenames()
        fh.write("#FormatVersion Mauve1\n")
        for i, g in enumerate(self.genomes):
            fh.write(f"#Sequence{i + 1}File\t{names[i]}\n")
            fh.write(f"#Sequence{i + 1}Entry\t{i + 1}\n")
            fh.write(f"#Sequence{i + 1}Format\tFastA\n")
        if self.backbone_filename:
            fh.write(f"#BackboneFile\t{self.backbone_filename}\n")
        _XmfaBlocks(self.genomes, names, width).write(fh, self.intervals)

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


# the byte that pads a header's fields to their tables' widths: UTF-8 never
# holds it, and a header is ASCII but for its name
_PAD = 0xFF


def _decimal(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative integers in decimal ASCII: an [n, len(x)] uint8 table,
    its column j the digits of x[j] right-aligned and padded with _PAD, and
    each one's count of digits."""
    n = len(str(int(x.max(initial=0))))
    rest = x.astype(np.uint32 if n < 10 else np.uint64)
    tab = np.empty((n, len(x)), np.uint8)
    n_digits = np.ones(len(x), np.int64)
    for i in range(n - 1, -1, -1):
        q = rest // 10
        tab[i] = rest - 10 * q
        rest = q
        if i:
            n_digits += x >= 10 ** (n - i)
    tab += ord("0")
    tab[np.arange(n)[:, None] < n - n_digits] = _PAD
    return tab, n_digits


def _table(strs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Byte strings left-aligned in a [len(strs), longest] uint8 table padded
    with _PAD, and their lengths."""
    lens = np.array([len(b) for b in strs], np.int64)
    w = int(lens.max(initial=0))
    tab = np.full((len(strs), w), _PAD, np.uint8)
    tab[np.arange(w) < lens[:, None]] = np.frombuffer(b"".join(strs), np.uint8)
    return tab, lens


class _XmfaBlocks:
    """The blocks of an XMFA file, each row a header line ("> j:left-right
    strand name", "> j:0-0 + name" where sequence j is absent) and its gapped
    text in lines of `width`, each block closed by "=".

    Runs of narrow blocks are assembled in chunks, each as one uint8 buffer
    with a fixed number of NumPy calls and one write; a wide block is
    written row by row.  The counters xmfa_rows and xmfa_rows_batched count
    the rows written and those assembled in chunks."""

    def __init__(self, genomes: Sequence[Genome], names: Sequence[str], width: int):
        self.genomes = genomes
        self.names = list(names)
        self.width = width
        self._all_seq = None  # every genome's bytes end to end, built on first use
        # a header's bytes before its left end, and after its right end by strand
        enc = [n.encode("utf-8", "surrogatepass") for n in self.names]
        self._open = _table([f"> {j + 1}:".encode() for j in range(len(enc))])
        self._close = _table([b" %s %s\n" % (s, n) for n in enc for s in (b"+", b"-")])

    def write(self, fh: TextIO, intervals: Sequence[Interval]) -> None:
        n = len(intervals)
        rows, cols = np.array([iv.aln.shape for iv in intervals], np.int64).reshape(n, 2).T
        batched = (cols <= _BATCH_MAX_COLS) & (rows > 0)
        # a chunk's size: its text and, at some 64 bytes a row, its headers
        size = np.concatenate([[0], np.cumsum(rows * (cols + 64))])
        lo = 0
        for wide in [*np.flatnonzero(~batched).tolist(), n]:
            # the narrow blocks before this wide one, in chunks of about _BATCH_BYTES
            while lo < wide:
                hi = int(np.searchsorted(size, size[lo] + _BATCH_BYTES, side="right")) - 1
                hi = min(max(hi, lo + 1), wide)
                fh.write(self._chunk(intervals[lo:hi], rows[lo:hi], cols[lo:hi]))
                lo = hi
            if wide < n:
                self._write_rows(fh, intervals[wide])
            lo = wide + 1
        timing.GLOBAL.add("xmfa_rows", float(rows.sum()))
        timing.GLOBAL.add("xmfa_rows_batched", float(rows[batched].sum()))

    def _write_rows(self, fh: TextIO, iv: Interval) -> None:
        """One block, a header and one mask store per row, its text's full
        lines laid out by one reshape."""
        lefts, rights = iv.lefts(), iv.rights()
        width, names = self.width, self.names
        for seq in range(iv.n_seqs):
            start = int(iv.starts[seq])
            if start == 0:
                fh.write(f"> {seq + 1}:0-0 + {names[seq]}\n")
            else:
                strand = "+" if start > 0 else "-"
                fh.write(f"> {seq + 1}:{lefts[seq]}-{rights[seq]} {strand} {names[seq]}\n")
            text = iv.aligned_bytes(self.genomes, seq)
            k, tail = divmod(len(text), width)
            lines = np.empty(len(text) + k + (tail > 0), np.uint8)
            body = lines[: k * (width + 1)].reshape(k, width + 1)
            body[:, :width] = text[: k * width].reshape(k, width)
            body[:, width] = ord("\n")
            if tail:
                lines[k * (width + 1) : -1] = text[k * width :]
                lines[-1] = ord("\n")
            fh.write(lines.tobytes().decode("ascii"))
        fh.write("=\n")

    def _genome_bytes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every genome's bytes end to end, with each genome's offset and
        length, and last an empty genome."""
        if self._all_seq is None:
            seqs = [g.seq for g in self.genomes]
            lens = np.array([len(s) for s in seqs] + [0], np.int64)
            self._all_seq = (np.concatenate(seqs + [np.zeros(0, np.uint8)]),
                             np.cumsum(lens) - lens, lens)
        return self._all_seq

    def _chunk(self, ivs: Sequence[Interval], n_rows: np.ndarray, n_cols: np.ndarray) -> str:
        """The text of consecutive blocks, each with a row or more."""
        width = self.width
        starts = np.concatenate([iv.starts for iv in ivs], dtype=np.int64)
        R = len(starts)
        first_row = np.cumsum(n_rows) - n_rows
        seq = np.arange(R) - np.repeat(first_row, n_rows)
        w = np.repeat(n_cols, n_rows)
        present = starts != 0
        # the gap structure, row after row; an absent row is all gaps
        aln = np.concatenate([iv.aln.ravel() for iv in ivs])
        aln &= np.repeat(present, w)
        done = np.zeros(aln.size + 1, np.int64)  # bases before each cell
        np.cumsum(aln, out=done[1:])
        bounds = done[np.concatenate([[0], np.cumsum(w)])]
        before, lens = bounds[:-1], np.diff(bounds)
        left = np.abs(starts)
        right = np.where(present, left + lens - 1, 0)

        # the bases: one gather, row by row in column order, from the left
        # end of a forward row and the right end of a reverse one
        all_seq, g_off, g_len = self._genome_bytes()
        g_row = np.minimum(seq, len(g_off) - 1)  # a row past the genomes reads none
        bad = (lens > 0) & (left - 1 + lens > g_len[g_row])
        if bad.any():
            r = int(np.flatnonzero(bad)[0])
            raise ValueError(f"a row of sequence {seq[r] + 1} at {starts[r]} holds "
                             f"{lens[r]} bases past the end of its genome")
        fwd = starts > 0
        g0 = g_off[g_row] + left - 1
        origin = np.where(fwd, g0 - before, g0 + lens - 1 + before)
        step = np.where(fwd, 1, -1)
        k = np.arange(int(bounds[-1]), dtype=np.int64)
        bases = all_seq[np.repeat(origin, lens) + np.repeat(step, lens) * k]
        rev = np.repeat(~fwd, lens)
        bases[rev] = complement_ascii(bases[rev])
        text = np.full(aln.size, ord("-"), np.uint8)
        text[aln] = bases

        # the headers as one table, a row each, its fields padded with _PAD:
        # "=\n" (closing the block before, in each block's first row but the
        # chunk's first), "> j:", left, "-", right and " strand name\n"
        lead = np.zeros(R, bool)
        lead[first_row[1:]] = True
        close = 2 * seq + (starts < 0)
        o_tab, o_len = self._open
        c_tab, c_len = self._close
        (l_tab, l_len), (r_tab, r_len) = _decimal(left), _decimal(right)
        fields = [np.frombuffer(b"=\n", np.uint8), o_tab[seq], l_tab.T,
                  np.frombuffer(b"-", np.uint8), r_tab.T, c_tab[close]]
        at = np.cumsum([0] + [t.shape[-1] for t in fields])
        table = np.empty((R, at[-1]), np.uint8)
        for t, a, b in zip(fields, at, at[1:]):
            table[:, a:b] = t
        table[~lead, :2] = _PAD
        heads = table[table != _PAD]
        head_len = 2 * lead + o_len[seq] + l_len + 1 + r_len + c_len[close]

        # the layout: per row its header, then per line its characters and
        # a newline; pieces of kind 0 (header), 1 (text) and 2 (newline)
        n_lines = -(-w // width)
        L = int(n_lines.sum())
        first_line = np.cumsum(n_lines) - n_lines
        head_piece = first_line * 2 + np.arange(R)
        text_piece = np.repeat(head_piece + 1 - 2 * first_line, n_lines) + 2 * np.arange(L)
        line_len = np.full(L, width, np.int64)
        has = n_lines > 0
        line_len[(first_line + n_lines - 1)[has]] = (w - (n_lines - 1) * width)[has]
        count = np.ones(R + 2 * L, np.int64)
        count[head_piece] = head_len
        count[text_piece] = line_len
        kind = np.full(R + 2 * L, 2, np.uint8)
        kind[head_piece] = 0
        kind[text_piece] = 1
        layout = np.repeat(kind, count)
        buf = np.full(len(layout) + 2, ord("\n"), np.uint8)
        body = buf[:-2]
        body[layout == 0] = heads
        body[layout == 1] = text
        buf[-2] = ord("=")
        return str(buf.data, "utf-8", "surrogatepass")
