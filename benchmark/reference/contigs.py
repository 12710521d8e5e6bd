"""The judgement of a sortContigs job: the reordered draft and its
placement log, against the draft the benchmark cut.

- The reordered FASTA must hold each of the draft's contigs exactly once,
  as it was or reverse-complemented, as its log line says ('-': reverse-
  complemented; unplaced contigs are kept as they were): `bad_contigs`.
- A contig is in place when it is placed on its true strand and follows
  its true predecessor in cut order (the first contig: comes first).
  `misplaced_share` is the share of contigs not in place; its complement
  is the end-to-end metric `contigs_in_place`.
- The anchor search must be the full one: `anchor_miss` is the share of
  the truth's homologous (reference, draft) position pairs that no anchor
  of the program's search claims.  sortContigs writes no anchors, so they
  are the ones the harness recorded from MauveAligner.find_mums in the warm
  job (capture.py).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import mln
from benchmark.traffic.generate import revcomp


def read_fasta(path: str):
    names, seqs, chunks = [], [], []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                if names:
                    seqs.append(b"".join(chunks))
                names.append(line[1:].decode().split()[0])
                chunks = []
            elif line:
                chunks.append(line)
    if names:
        seqs.append(b"".join(chunks))
    return names, [np.frombuffer(s, np.uint8) for s in seqs]


def read_log(path: str):
    """[(name, strand)] from sortContigs' printed lines: +1, -1, or 0 for
    an unplaced contig."""
    out = []
    with open(path) as fh:
        for line in fh:
            if "\t" not in line:
                continue
            name, mark = line.rstrip("\n").split("\t", 1)
            out.append((name, 0 if "unplaced" in mark else (-1 if mark.startswith("-") else 1)))
    return out


def judge(inputs, outputs, captured, device):
    draft = inputs.draft
    given = dict(zip(draft.names, draft.seqs))
    rank = dict(zip(draft.names, draft.true_rank.tolist()))
    flipped = dict(zip(draft.names, draft.flipped.tolist()))
    names, seqs = read_fasta(outputs["fasta"])
    log = read_log(outputs["stdout"])
    strand = dict(log)
    bad = 0
    if sorted(names) != sorted(draft.names) or [n for n, _ in log] != names:
        bad += 1 + abs(len(names) - len(draft.names))
    for name, seq in zip(names, seqs):
        want = given.get(name)
        if want is None:
            bad += 1
            continue
        if strand.get(name, 0) < 0:
            want = revcomp(want)
        if not np.array_equal(seq, want):
            bad += 1
    in_place = 0
    for q, name in enumerate(names):
        s = strand.get(name, 0)
        if name not in rank or s == 0 or (s < 0) != flipped[name]:
            continue
        r = rank[name]
        if (q == 0 and r == 0) or (q > 0 and rank.get(names[q - 1]) == r - 1):
            in_place += 1
    share = in_place / max(len(draft.names), 1)
    anchors = captured.get("anchors", np.zeros((0, 3), np.int64))
    numbers = {"bad_contigs": bad, "misplaced_share": 1.0 - share,
               "anchor_miss": mln.unanchored_share(anchors, draft.truth, len(inputs.genomes[1]))}
    report = {"contigs": len(draft.names), "contigs_in_place": share,
              "unplaced": sum(1 for _, s in log if s == 0)}
    return numbers, report
