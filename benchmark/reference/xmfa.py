"""Reading XMFA files and judging them against the input genomes.

An XMFA file is read into columns: its blocks laid end to end, and for
every genome its aligned text and signed positions over all columns
(`Alignment.rows_of`), built with a few array operations per genome
rather than per block, since a progressive alignment has tens of thousands
of small blocks.  A row of a genome absent from a block (``0-0``) holds no
columns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.traffic.generate import COMP

GAP = ord("-")
NO_ROW = 0  # text of a column in a block that has no row of the genome


@dataclasses.dataclass
class Rows:
    """One genome's rows over the alignment's columns."""

    text: np.ndarray       # [n_cols] uint8: the letter, GAP, or NO_ROW
    pos: np.ndarray        # [n_cols] int64: signed 1-based position, 0 at a gap
    row: np.ndarray        # [n_cols] int64: the row's number, -1 without one


@dataclasses.dataclass
class Alignment:
    n_cols: int
    block_start: np.ndarray   # [n_blocks + 1] first column of each block
    seq: np.ndarray           # per row: genome, left, right, strand (+1/-1), block
    left: np.ndarray
    right: np.ndarray
    strand: np.ndarray
    block: np.ndarray
    text: np.ndarray          # every row's text, end to end
    text_start: np.ndarray    # [n_rows + 1]
    ragged_blocks: int

    @property
    def n_blocks(self) -> int:
        return len(self.block_start) - 1

    def rows_of(self, s: int) -> Rows:
        rows = np.flatnonzero(self.seq == s)
        L = np.diff(self.text_start)[rows]
        first = np.cumsum(L) - L
        k = np.arange(int(L.sum())) - np.repeat(first, L)
        t = _upper(self.text[np.repeat(self.text_start[rows], L) + k])
        col = np.repeat(self.block_start[self.block[rows]], L) + k
        base = t != GAP
        c = np.cumsum(base)
        rank = c - np.repeat(np.concatenate([[0], c])[first], L)
        fwd = np.repeat(self.strand[rows] > 0, L)
        val = np.where(fwd, np.repeat(self.left[rows], L) + rank - 1,
                       -(np.repeat(self.right[rows], L) - rank + 1))
        out = Rows(np.full(self.n_cols, NO_ROW, np.uint8), np.zeros(self.n_cols, np.int64),
                   np.full(self.n_cols, -1, np.int64))
        out.text[col] = t
        out.pos[col] = np.where(base, val, 0)
        out.row[col] = np.repeat(rows, L)
        return out


def read_xmfa(path: str) -> Alignment:
    heads, texts, widths, blocks = [], [], [], 0
    ragged = 0
    chunks: List[bytes] = []
    head = None
    cur: List[int] = []  # lengths of the rows of the current block

    def flush():
        nonlocal head, chunks
        if head is not None:
            text = b"".join(chunks)
            cur.append(len(text))
            if head[1] > 0:
                heads.append((*head, blocks))
                texts.append(text)
        head, chunks = None, []

    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if not line or line.startswith(b"#"):
                continue
            if line.startswith(b">"):
                flush()
                coord, strand = line[1:].split()[:2]
                seq, span = coord.split(b":")
                left, right = span.split(b"-")
                head = (int(seq) - 1, int(left), int(right), 1 if strand == b"+" else -1)
            elif line.startswith(b"="):
                flush()
                ragged += len(set(cur)) > 1
                widths.append(max(cur, default=0))
                cur = []
                blocks += 1
            else:
                chunks.append(line)
    flush()
    if cur:
        ragged += len(set(cur)) > 1
        widths.append(max(cur))
        blocks += 1
    h = np.array(heads, np.int64).reshape(-1, 5)
    lens = np.array([len(t) for t in texts], np.int64)
    return Alignment(
        n_cols=int(sum(widths)),
        block_start=np.concatenate([[0], np.cumsum(widths)]).astype(np.int64),
        seq=h[:, 0], left=h[:, 1], right=h[:, 2], strand=h[:, 3], block=h[:, 4],
        text=np.frombuffer(b"".join(texts), np.uint8),
        text_start=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
        ragged_blocks=int(ragged))


def _upper(text: np.ndarray) -> np.ndarray:
    lower = (text >= ord("a")) & (text <= ord("z"))
    return np.where(lower, text - 32, text).astype(np.uint8)


def validity(aln: Alignment, genomes: Sequence[np.ndarray]) -> Dict[str, int]:
    """The counts an alignment of `genomes` must have at 0, and one count to
    report: rows whose bases are not the genome's interval (`bad_rows`),
    genome bases held by more than one row (`bases_twice`), blocks whose
    rows differ in length (`ragged_blocks`), and bases held by no row
    (`bases_unaligned`, 0 only where the file must hold every base)."""
    n_rows = len(aln.seq)
    bad = np.zeros(n_rows, bool)
    twice = unaligned = 0
    for s, g in enumerate(genomes):
        rows = aln.rows_of(s)
        sel = aln.seq == s
        out = ~((aln.left[sel] >= 1) & (aln.left[sel] <= aln.right[sel])
                & (aln.right[sel] <= len(g)))
        bad[np.flatnonzero(sel)[out]] = True
        has = (rows.pos != 0) & (np.abs(rows.pos) <= len(g))
        at = np.abs(rows.pos[has]) - 1
        want = np.where(rows.pos[has] > 0, g[at], COMP[g[at]])
        wrong = np.bincount(rows.row[has], weights=rows.text[has] != want, minlength=n_rows)
        count = np.bincount(rows.row[rows.pos != 0], minlength=n_rows)
        span = aln.right - aln.left + 1
        bad |= sel & ((wrong > 0) | (count != span))
        depth = np.bincount(np.abs(rows.pos[has]), minlength=len(g) + 1)[1:len(g) + 1]
        twice += int(np.sum(depth > 1))
        unaligned += int(np.sum(depth == 0))
    return {"bad_rows": int(bad.sum()), "ragged_blocks": aln.ragged_blocks,
            "bases_twice": twice, "bases_unaligned": unaligned}


def pair_map(rows_i: Rows, rows_j: Rows, len_i: int) -> np.ndarray:
    """For every 1-based position of genome i, the signed position of genome
    j that the alignment puts in its column (negative where the two rows lie
    on opposite strands), 0 where none; a later block overrides an earlier
    one, as the program's position maps do."""
    out = np.zeros(len_i + 1, np.int64)
    both = (rows_i.pos != 0) & (rows_j.pos != 0)
    pi, pj = rows_i.pos[both], rows_j.pos[both]
    out[np.abs(pi)] = np.where(np.sign(pi) == np.sign(pj), 1, -1) * np.abs(pj)
    return out


def accuracy(maps: Sequence[np.ndarray], truths: Sequence[np.ndarray]) -> Tuple[float, float, Dict]:
    """Pooled sensitivity and positive predictive value of the alignment's
    position maps against the truths: a truth-aligned position counts as
    found where the alignment maps it to the same signed position; an
    aligned position counts as false where it maps it anywhere else."""
    tp = fn = fp = 0
    for a, t in zip(maps, truths):
        tmask = t != 0
        hit = int(np.sum(tmask & (a == t)))
        tp += hit
        fn += int(tmask.sum()) - hit
        fp += int(np.sum((a != 0) & (a != t)))
    return tp / max(tp + fn, 1), tp / max(tp + fp, 1), {"tp": tp, "fn": fn, "fp": fp}
