"""Shared helpers for the CLI tools."""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, TextIO

from mauvealigner_tpu_torch.genome import read_fasta, read_genbank, read_raw
from mauvealigner_tpu_torch.genome.sequence import Genome


def load_genome(path: str) -> Genome:
    """Load by extension: FASTA (default), GenBank (.gbk/.gb), raw (.raw)."""
    low = path.lower()
    if low.endswith((".gbk", ".gb", ".genbank")):
        return read_genbank(path)
    if low.endswith(".raw"):
        return read_raw(path)
    return read_fasta(path)


def load_genomes(paths: Sequence[str]) -> List[Genome]:
    return [load_genome(p) for p in paths]


class _NonClosing:
    """Context-manager wrapper that never closes the underlying stream —
    `with open_out("-") as fh` must not close sys.stdout."""

    def __init__(self, fh):
        self._fh = fh

    def __getattr__(self, name):
        return getattr(self._fh, name)

    def __enter__(self):
        return self._fh

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


def open_out(path: Optional[str]) -> TextIO:
    if path in (None, "", "-"):
        return _NonClosing(sys.stdout)
    return open(path, "w")


def write_fasta_row(fh: TextIO, name: str, text: str, width: int = 80) -> None:
    """One `>name` record with the body wrapped at `width` columns."""
    fh.write(f">{name}\n")
    for c in range(0, len(text), width):
        fh.write(text[c : c + width] + "\n")
