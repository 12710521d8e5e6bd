"""Accuracy scoring for repeat (local multiple) alignments.

Port of mauvealigner_tpu/analysis/repeat_score.py (host NumPy).
Equivalents of scoreProcrastAlignment (src/scoreProcrastAlignment.cpp) —
base-pair-level sensitivity/PPV of a calculated repeat alignment against a
known-correct one — and scoreALU (src/scoreALU.cpp) — validation against
RepeatMasker ALU annotations as biological ground truth (AluRecord parser
src/scoreALU.cpp:28-60).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Set, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.models.repeatoire import RepeatFamily


def aligned_pairs(fams: Sequence[RepeatFamily], sample_limit: int = 10**7) -> Set[Tuple[int, int]]:
    """All aligned position pairs (p < q, absolute 1-based genome positions)
    across every family's columns."""
    pairs: Set[Tuple[int, int]] = set()
    for fam in fams:
        k = fam.multiplicity
        lens = fam.component_lengths()
        # per-component genome position per column (signed orientation aware)
        pos = np.zeros((k, fam.n_cols), np.int64)
        for i in range(k):
            s = int(fam.starts[i])
            rank = np.cumsum(fam.aln[i])
            if s > 0:
                vals = abs(s) + rank - 1
            else:
                vals = abs(s) + int(lens[i]) - rank
            pos[i] = np.where(fam.aln[i], vals, 0)
        for i in range(k):
            for j in range(i + 1, k):
                both = (pos[i] != 0) & (pos[j] != 0)
                for p, q in zip(pos[i][both], pos[j][both]):
                    a, b = int(p), int(q)
                    pairs.add((a, b) if a < b else (b, a))
                    if len(pairs) > sample_limit:
                        return pairs
    return pairs


@dataclasses.dataclass
class RepeatScore:
    tp: int
    fn: int
    fp: int

    @property
    def sensitivity(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 1.0

    @property
    def ppv(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 1.0


def score_procrast_alignment(
    correct: Sequence[RepeatFamily], calculated: Sequence[RepeatFamily]
) -> RepeatScore:
    truth = aligned_pairs(correct)
    pred = aligned_pairs(calculated)
    tp = len(truth & pred)
    return RepeatScore(tp, len(truth) - tp, len(pred) - tp)


# -- RepeatMasker ALU validation -------------------------------------------

@dataclasses.dataclass
class AluRecord:
    score: int
    query: str
    begin: int   # 1-based
    end: int
    strand: int
    repeat_name: str
    repeat_class: str


def parse_repeatmasker(src: Union[str, TextIO]) -> List[AluRecord]:
    """Parse RepeatMasker .out records (AluRecord parser equivalent)."""
    if isinstance(src, str):
        with open(src) as fh:
            return parse_repeatmasker(fh)
    out = []
    for line in src:
        toks = line.split()
        if len(toks) < 11 or not toks[0].isdigit():
            continue
        out.append(
            AluRecord(
                score=int(toks[0]),
                query=toks[4],
                begin=int(toks[5]),
                end=int(toks[6]),
                strand=-1 if toks[8] == "C" else 1,
                repeat_name=toks[9],
                repeat_class=toks[10],
            )
        )
    return out


def score_alu(
    fams: Sequence[RepeatFamily],
    annotations: Sequence[AluRecord],
    repeat_class_filter: str = "Alu",
) -> dict:
    """Fraction of annotated repeat bases recovered by the detected families
    and fraction of detected bases falling inside annotations."""
    annos = [a for a in annotations if repeat_class_filter in (a.repeat_class or "")
             or repeat_class_filter in (a.repeat_name or "")]
    if not annos:
        annos = list(annotations)
    max_pos = max((a.end for a in annos), default=0)
    for fam in fams:
        if len(fam.starts):
            max_pos = max(max_pos, int(fam.spans().max()))
    anno_mask = np.zeros(max_pos + 2, bool)
    for a in annos:
        anno_mask[a.begin : a.end + 1] = True
    det_mask = np.zeros(max_pos + 2, bool)
    for fam in fams:
        for l, r in fam.spans():
            det_mask[l : min(r, max_pos) + 1] = True
    tp = int((anno_mask & det_mask).sum())
    return {
        "annotated_bases": int(anno_mask.sum()),
        "detected_bases": int(det_mask.sum()),
        "sensitivity": tp / max(int(anno_mask.sum()), 1),
        "ppv": tp / max(int(det_mask.sum()), 1),
    }
