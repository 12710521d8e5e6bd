"""Match-list and interval-list flat-file serialization.

Equivalent of libMems WriteList/ReadList for MatchList (--mums output,
src/mauveAligner.cpp:594-626; --match-input, src/progressiveMauve.cpp:367-385)
and for IntervalList (.mln Mauve interval format, ReadList call site
src/sortContigs.cpp:14-41).

Format (text, tab-separated):

  FormatVersion<TAB>4
  SequenceCount<TAB>N
  Sequence{i}File<TAB>name
  Sequence{i}Length<TAB>len
  MatchCount<TAB>M          (match list)      | IntervalCount<TAB>K (intervals)
  <length> <start0> ... <startN-1>            | Interval<TAB>k<TAB>ncols
                                              | <start0> ... <startN-1>
                                              | per-seq 0/1 gap rows
"""

from __future__ import annotations

from typing import List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.genome.sequence import Genome


def write_match_list(
    ml: MatchList,
    out: Union[str, TextIO],
    seq_names: Sequence[str] = (),
    seq_lengths: Sequence[int] = (),
) -> None:
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_match_list(ml, fh, seq_names, seq_lengths)
            return
    fh = out
    n = ml.n_seqs
    fh.write("FormatVersion\t4\n")
    fh.write(f"SequenceCount\t{n}\n")
    for i in range(n):
        name = seq_names[i] if i < len(seq_names) else f"seq{i}"
        length = seq_lengths[i] if i < len(seq_lengths) else 0
        fh.write(f"Sequence{i}File\t{name}\n")
        fh.write(f"Sequence{i}Length\t{length}\n")
    fh.write(f"MatchCount\t{len(ml)}\n")
    for k in range(len(ml)):
        row = " ".join(str(int(v)) for v in ml.starts[k])
        fh.write(f"{int(ml.lengths[k])} {row}\n")


def read_match_list(src: Union[str, TextIO]) -> Tuple[MatchList, List[str], List[int]]:
    if isinstance(src, str):
        with open(src) as fh:
            return read_match_list(fh)
    fh = src
    n = 0
    names: List[str] = []
    lengths_meta: List[int] = []
    starts: List[List[int]] = []
    lens: List[int] = []
    n_matches = None
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if "\t" in line:
            key, val = line.split("\t", 1)
            if key == "SequenceCount":
                n = int(val)
                names = [f"seq{i}" for i in range(n)]
                lengths_meta = [0] * n
            elif key.startswith("Sequence") and key.endswith("File"):
                names[int(key[len("Sequence") : -len("File")])] = val
            elif key.startswith("Sequence") and key.endswith("Length"):
                lengths_meta[int(key[len("Sequence") : -len("Length")])] = int(val)
            elif key == "MatchCount":
                n_matches = int(val)
            continue
        toks = line.split()
        lens.append(int(toks[0]))
        starts.append([int(t) for t in toks[1 : 1 + n]])
    ml = MatchList(
        np.array(starts, np.int64).reshape(len(lens), n),
        np.array(lens, np.int64),
    )
    return ml, names, lengths_meta


def write_interval_list(ivs: IntervalList, out: Union[str, TextIO]) -> None:
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_interval_list(ivs, fh)
            return
    fh = out
    n = ivs.n_seqs
    fh.write("FormatVersion\t4\n")
    fh.write(f"SequenceCount\t{n}\n")
    names = ivs.filenames()
    for i in range(n):
        fh.write(f"Sequence{i}File\t{names[i]}\n")
        fh.write(f"Sequence{i}Length\t{len(ivs.genomes[i]) if i < len(ivs.genomes) else 0}\n")
    fh.write(f"IntervalCount\t{len(ivs.intervals)}\n")
    for k, iv in enumerate(ivs.intervals):
        fh.write(f"Interval\t{k}\t{iv.n_cols}\n")
        fh.write(" ".join(str(int(v)) for v in iv.starts) + "\n")
        for s in range(iv.n_seqs):
            row = np.where(iv.aln[s], np.uint8(49), np.uint8(48)).tobytes().decode()
            fh.write(row + "\n")


def read_interval_list(
    src: Union[str, TextIO], genomes: Optional[List[Genome]] = None
) -> IntervalList:
    if isinstance(src, str):
        with open(src) as fh:
            return read_interval_list(fh, genomes)
    fh = src
    n = 0
    names: List[str] = []
    intervals: List[Interval] = []
    lines = iter(fh)
    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("SequenceCount"):
            n = int(line.split("\t")[1])
            names = [f"seq{i}" for i in range(n)]
        elif line.startswith("Sequence") and "File" in line.split("\t")[0]:
            key, val = line.split("\t", 1)
            names[int(key[len("Sequence") : -len("File")])] = val
        elif line.startswith("Interval\t"):
            _, k, ncols = line.split("\t")
            ncols = int(ncols)
            starts = np.array([int(t) for t in next(lines).split()], np.int64)
            aln = np.zeros((n, ncols), bool)
            for s in range(n):
                row = next(lines).strip()
                aln[s] = np.frombuffer(row.encode(), np.uint8) == ord("1")
            intervals.append(Interval(starts, aln))
    gs = genomes or [Genome.from_string("") for _ in range(n)]
    return IntervalList(genomes=gs, intervals=intervals, seq_filenames=names)
