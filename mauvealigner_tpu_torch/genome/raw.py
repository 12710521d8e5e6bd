"""Raw byte-sequence read/write (gnRAWSource equivalent).

The reference rewrites inputs in RAW format for fast mmap access
(LoadAndCreateRawSequences, src/progressiveMauve.cpp:444;
src/toRawSequence.cpp).  Here RAW is a plain byte file of sequence only.
"""

from __future__ import annotations

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Genome


def read_raw(path: str, name: str = "") -> Genome:
    data = np.fromfile(path, dtype=np.uint8)
    # strip any whitespace/newlines defensively
    keep = (data != ord("\n")) & (data != ord("\r")) & (data != ord(" "))
    return Genome(data[keep], name=name or path, filename=path)


def write_raw(genome: Genome, path: str) -> None:
    genome.seq.tofile(path)
