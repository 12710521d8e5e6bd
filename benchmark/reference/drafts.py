"""The judgement of a sortContigs job over several drafts: each reordered
draft and its block of the placement log, against the draft the benchmark
cut, as reference/contigs.py judges one draft.

sortContigs with several drafts writes each reordered draft to its own file
(the workload's outputs ``draft0`` .. ``draft{n-1}``) and prints, per draft
in the order given, a line naming the draft's file (no tab) and then its
placement lines.  Pooled over the drafts:

- `bad_contigs`: contigs not written exactly once as the log says (summed);
- `drafts_missing`: drafts with no reordered file or no block in the log;
- `misplaced_share`: the share of all the drafts' contigs not in place (a
  missing draft's contigs are all misplaced); its complement is the
  end-to-end metric `contigs_in_place`;
- `anchor_miss`: the share of all the drafts' truth (reference, draft)
  position pairs that no anchor of the draft's own search claims, from the
  anchors the harness recorded of the sharded pair search
  (``captured["pair_anchors"]``, one array per draft in the order given).  A
  draft with no anchor array counts as wholly unanchored.

NumPy only.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference.contigs import read_fasta
from benchmark.traffic.generate import revcomp


def read_logs(path: str) -> dict:
    """{basename of the named file: [(name, strand)]} from sortContigs'
    printed lines over several drafts; strands as contigs.read_log reads
    them (+1, -1, or 0 for an unplaced contig)."""
    blocks: dict = {}
    current = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if "\t" not in line:
                if line:
                    current = blocks.setdefault(os.path.basename(line), [])
                continue
            if current is None:
                continue
            name, mark = line.split("\t", 1)
            current.append((name, 0 if "unplaced" in mark else (-1 if mark.startswith("-") else 1)))
    return blocks


def _bad_contigs(draft, names, seqs, log) -> int:
    """contigs.judge's count for one draft: the file and the log must hold
    every contig once, in one order, each as its log line says."""
    given = dict(zip(draft.names, draft.seqs))
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
    return bad


def _in_place(draft, names, log) -> int:
    """Contigs on their true strand right after their true predecessor
    (the first contig: first in the file)."""
    rank = dict(zip(draft.names, draft.true_rank.tolist()))
    flipped = dict(zip(draft.names, draft.flipped.tolist()))
    strand = dict(log)
    n = 0
    for q, name in enumerate(names):
        s = strand.get(name, 0)
        if name not in rank or s == 0 or (s < 0) != flipped[name]:
            continue
        r = rank[name]
        if (q == 0 and r == 0) or (q > 0 and rank.get(names[q - 1]) == r - 1):
            n += 1
    return n


def _missed_pairs(anchors, truth: np.ndarray):
    """(truth pairs no anchor claims, truth pairs) for one draft: the
    counts behind mln.unanchored_share, with every position an anchor
    claims looked up in the truth instead of matched by a sort (the same
    pairs as mln.anchor_pair_keys, a few times faster at 4.6 Mbp)."""
    p0 = np.flatnonzero(truth[1:]) + 1
    if anchors is None or len(anchors) == 0:
        return len(p0), len(p0)
    m = anchors[(anchors[:, 1] != 0) & (anchors[:, 2] != 0)]
    lengths = m[:, 0]
    off = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    a0, a1 = np.abs(m[:, 1]), np.abs(m[:, 2])
    same = np.sign(m[:, 1]) == np.sign(m[:, 2])
    q0 = np.repeat(a0, lengths) + off
    # on opposite strands the first base of one pairs with the last of the other
    q1 = np.where(np.repeat(same, lengths), np.repeat(a1, lengths) + off,
                  -(np.repeat(a1 + lengths - 1, lengths) - off))
    inside = q0 < len(truth)
    q0, q1 = q0[inside], q1[inside]
    claimed = np.zeros(len(truth), bool)
    claimed[q0[truth[q0] == q1]] = True
    return int((~claimed[p0]).sum()), len(p0)


def judge(inputs, outputs, captured, device):
    logs = read_logs(outputs["stdout"])
    anchors = list(captured.get("pair_anchors", []))
    anchors += [None] * (len(inputs.drafts) - len(anchors))
    bad = missing = in_place = contigs = unplaced = missed = pairs = 0
    for k, draft in enumerate(inputs.drafts):
        contigs += len(draft.names)
        m, n = _missed_pairs(anchors[k], draft.truth)
        missed += m
        pairs += n
        path = outputs.get(f"draft{k}")
        log = logs.get(os.path.basename(inputs.files[k + 1]))
        if path is None or not os.path.exists(path) or log is None:
            missing += 1
            continue
        names, seqs = read_fasta(path)
        bad += _bad_contigs(draft, names, seqs, log)
        in_place += _in_place(draft, names, log)
        unplaced += sum(1 for _, s in log if s == 0)
    share = in_place / max(contigs, 1)
    numbers = {"bad_contigs": bad, "drafts_missing": missing, "misplaced_share": 1.0 - share,
               "anchor_miss": missed / max(pairs, 1)}
    report = {"drafts": len(inputs.drafts), "contigs": contigs, "contigs_in_place": share,
              "unplaced": unplaced}
    return numbers, report
