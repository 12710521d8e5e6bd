"""L0: sequence I/O & genome model (TPU-native equivalent of libGenome).

Reference surface reproduced (SURVEY.md §2.3 row `gnSequence`):
multi-contig genomes, FASTA/GenBank/raw parse+write, revcomp filter,
CDS features, global<->local coordinates, N-masking with coordinate
transposition (src/mauveAligner.cpp:629-637).
"""

from mauvealigner_tpu_torch.genome.sequence import (
    Genome,
    Contig,
    CODE_A,
    CODE_C,
    CODE_G,
    CODE_T,
    CODE_N,
    encode_ascii,
    decode_codes,
    revcomp_ascii,
    revcomp_codes,
)
from mauvealigner_tpu_torch.genome.fasta import read_fasta, write_fasta
from mauvealigner_tpu_torch.genome.raw import read_raw, write_raw
from mauvealigner_tpu_torch.genome.genbank import read_genbank

__all__ = [
    "Genome",
    "Contig",
    "CODE_A",
    "CODE_C",
    "CODE_G",
    "CODE_T",
    "CODE_N",
    "encode_ascii",
    "decode_codes",
    "revcomp_ascii",
    "revcomp_codes",
    "read_fasta",
    "write_fasta",
    "read_raw",
    "write_raw",
    "read_genbank",
]
