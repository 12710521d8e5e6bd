"""FASTA read/write (gnFASSource equivalent).

Multi-record FASTA files become a single multi-contig Genome (the reference
concatenates contigs into one gnSequence coordinate space; LoadMFASequences
at src/mauveAligner.cpp:453 instead treats each record as a separate genome —
both entry points are provided).
"""

from __future__ import annotations

import io
from typing import List, TextIO, Union

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Contig, Genome


def _iter_fasta_records(handle: TextIO):
    name = None
    chunks: List[bytes] = []
    for line in handle:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, b"".join(chunks)
            name = line[1:].strip()
            chunks = []
        else:
            # drop interior whitespace like the native fast path (some
            # exporters space-group sequence lines); keeping it would shift
            # every downstream coordinate vs the native parser
            chunks.append("".join(line.split()).encode("ascii"))
    if name is not None:
        yield name, b"".join(chunks)


def read_fasta(path_or_handle: Union[str, TextIO], name: str = "") -> Genome:
    """Read a (multi-contig) FASTA file into one Genome."""
    if isinstance(path_or_handle, str):
        from mauvealigner_tpu_torch import native

        mod = native.get()
        if mod is not None:
            with open(path_or_handle, "rb") as fh:
                seq_bytes, contig_info = mod.parse_fasta(fh.read())
            if not contig_info:
                raise ValueError("empty FASTA input")
            contigs = []
            offset = 0
            for cname, length in contig_info:
                contigs.append(Contig(cname, length, offset))
                offset += length
            return Genome(
                np.frombuffer(seq_bytes, dtype=np.uint8),
                contigs=contigs,
                name=contigs[0].name,
                filename=name or path_or_handle,
            )
        with open(path_or_handle) as fh:
            return read_fasta(fh, name=name or path_or_handle)
    contigs: List[Contig] = []
    parts: List[bytes] = []
    offset = 0
    for rec_name, seq in _iter_fasta_records(path_or_handle):
        contigs.append(Contig(rec_name, len(seq), offset))
        parts.append(seq)
        offset += len(seq)
    if not contigs:
        raise ValueError("empty FASTA input")
    seq_arr = np.frombuffer(b"".join(parts), dtype=np.uint8)
    fname = name if isinstance(name, str) else ""
    return Genome(seq_arr, contigs=contigs, name=contigs[0].name, filename=fname)


def read_fasta_records(path_or_handle: Union[str, TextIO]) -> List[Genome]:
    """Read a multi-FASTA file as a list of single-contig Genomes
    (LoadMFASequences semantics, src/mauveAligner.cpp:453)."""
    if isinstance(path_or_handle, str):
        with open(path_or_handle) as fh:
            genomes = read_fasta_records(fh)
            for g in genomes:
                g.filename = path_or_handle
            return genomes
    out = []
    for rec_name, seq in _iter_fasta_records(path_or_handle):
        out.append(Genome(np.frombuffer(seq, dtype=np.uint8), name=rec_name))
    return out


def write_fasta(genome: Genome, path_or_handle: Union[str, TextIO], width: int = 80) -> None:
    if isinstance(path_or_handle, str):
        with open(path_or_handle, "w") as fh:
            write_fasta(genome, fh, width=width)
            return
    fh = path_or_handle
    for c in genome.contigs:
        fh.write(f">{c.name}\n")
        chunk = genome.seq[c.offset : c.offset + c.length].tobytes().decode("ascii")
        for i in range(0, len(chunk), width):
            fh.write(chunk[i : i + width])
            fh.write("\n")


def fasta_string(genome: Genome, width: int = 80) -> str:
    buf = io.StringIO()
    write_fasta(genome, buf, width=width)
    return buf.getvalue()
