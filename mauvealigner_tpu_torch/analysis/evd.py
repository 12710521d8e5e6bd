"""Extreme-value-distribution calibration of alignment score significance.

Equivalent of the reference's evd / multiEVD tools (src/evd.cpp:13-66,
src/multiEVD.cpp): simulate score excursions ("local record heights") of
random pairwise alignments under the hoxd scoring scheme and fit a Gumbel
law, used to set island/HSS significance thresholds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

from mauvealigner_tpu_torch.ops import dp


@dataclasses.dataclass
class EvdResult:
    n_excursions: int
    mean_height: float
    max_height: float
    gumbel_lambda: float
    gumbel_mu: float

    def summary(self) -> str:
        return (
            f"excursions: {self.n_excursions}\n"
            f"mean record height: {self.mean_height:.3f}\n"
            f"max record height: {self.max_height:.3f}\n"
            f"lambda: {self.gumbel_lambda:.6f}\n"
            f"mu: {self.gumbel_mu:.3f}\n"
        )


def score_excursions(scores: np.ndarray) -> np.ndarray:
    """Maximal ladder-excursion heights of a per-column score sequence
    (Karlin-Altschul local records; 'local record heights', src/evd.cpp:13)."""
    heights = []
    cur = 0.0
    best = 0.0
    for s in scores:
        cur += s
        if cur <= 0:
            if best > 0:
                heights.append(best)
            cur = 0.0
            best = 0.0
        else:
            best = max(best, cur)
    if best > 0:
        heights.append(best)
    return np.array(heights)


def simulate_evd(
    seq_length: int = 10000,
    n_trials: int = 20,
    gc_content: float = 0.5,
    identity: float = 0.25,
    subst: np.ndarray = dp.HOXD70,
    seed: int = 37,
) -> EvdResult:
    """Simulate unrelated sequence pairs, score column-wise with the hoxd
    matrix, and collect excursion heights."""
    rng = np.random.default_rng(seed)
    p = np.array(
        [(1 - gc_content) / 2, gc_content / 2, gc_content / 2, (1 - gc_content) / 2]
    )
    heights: List[float] = []
    for _ in range(n_trials):
        a = rng.choice(4, size=seq_length, p=p)
        b = rng.choice(4, size=seq_length, p=p)
        scores = subst[a, b].astype(float)
        heights.extend(score_excursions(scores).tolist())
    h = np.array(heights)
    if len(h) == 0:
        return EvdResult(0, 0.0, 0.0, 0.0, 0.0)
    # Gumbel moment fit: var = pi^2/(6 lambda^2); mean = mu + gamma/lambda
    lam = math.pi / math.sqrt(6 * max(h.var(), 1e-9))
    mu = float(h.mean()) - 0.5772156649 / lam
    return EvdResult(len(h), float(h.mean()), float(h.max()), lam, mu)


def pairwise_inverted_scores(
    col_codes_i: np.ndarray,
    col_codes_j: np.ndarray,
    subst: np.ndarray = dp.HOXD70,
    gap_open: float = dp.DEFAULT_GAP_OPEN,
    gap_extend: float = dp.DEFAULT_GAP_EXTEND,
) -> np.ndarray:
    """Per-column INVERTED alignment scores for one pair: substitution
    scores at base columns, affine gap charges at gap columns (open at run
    starts per sequence, extend per column), both-gap columns dropped.
    Scores are negated because the excursions of interest are bouts of
    NON-homologous sequence inside a homologous alignment
    (src/evd.cpp:36-38)."""
    a, b = col_codes_i, col_codes_j
    keep = ~((a == 5) & (b == 5))
    a, b = a[keep], b[keep]
    scores = np.zeros(len(a), np.float64)
    both = (a < 5) & (b < 5)
    scores[both] = subst[a[both], b[both]]
    for g in (a == 5, b == 5):
        if g.any():
            scores[g] += gap_extend
            starts = g.copy()
            starts[1:] &= ~g[:-1]
            scores[starts] += gap_open
    return -scores


def local_record_heights(ivs, genomes=None) -> np.ndarray:
    """Inverted-score excursion heights over every pairwise projection of
    every interval (getLocalRecordHeights, src/evd.cpp:13-66)."""
    from mauvealigner_tpu_torch.analysis.sp import interval_column_codes

    genomes = genomes if genomes is not None else ivs.genomes
    heights: List[float] = []
    for iv in ivs.intervals:
        codes = interval_column_codes(iv, genomes)
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        for x in range(len(present)):
            for y in range(x + 1, len(present)):
                i, j = present[x], present[y]
                scores = pairwise_inverted_scores(codes[i], codes[j])
                heights.extend(score_excursions(scores).tolist())
    return np.array(heights)


def quantile_summary(lrh: np.ndarray, n_sims: int) -> str:
    """The reference evd tool's output block (src/evd.cpp:108-128)."""
    out = [f"Total number of simulations: {n_sims}",
           f"Total number of excursions: {len(lrh)}"]
    if len(lrh):
        s = np.sort(lrh)
        for label, q in (("95%", 0.95), ("99%", 0.99),
                         ("99.9%", 0.999), ("99.99%", 0.9999)):
            idx = min(int(len(s) * q), len(s) - 1)
            out.append(f"{label} score threshold: {s[idx]:g}")
            out.append(f"Number excursions above {label}: {len(s) - idx}")
    return "\n".join(out) + "\n"


def alignjob_heights(run_count: int, directory: str = ".") -> tuple:
    """Collect local record heights from alignjob.N/evolved.dat alignments
    (the reference evd main loop, src/evd.cpp:80-106).  Returns
    (heights, simulations_read)."""
    import os

    from mauvealigner_tpu_torch.core.interval import IntervalList
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records

    all_h: List[float] = []
    n_sims = 0
    for run in range(run_count):
        aln = os.path.join(directory, f"alignjob.{run}", "evolved.dat")
        seqs = os.path.join(directory, f"alignjob.{run}", "evolved_seqs.fas")
        if not (os.path.exists(aln) and os.path.exists(seqs)):
            import sys

            print(f"Error opening {aln if not os.path.exists(aln) else seqs}",
                  file=sys.stderr)
            continue
        n_sims += 1
        ivl = IntervalList.read_xmfa(aln)
        genomes = read_fasta_records(seqs)
        all_h.extend(local_record_heights(ivl, genomes).tolist())
    return np.array(all_h), n_sims


def multi_evd_table(run_count: int, directory: str = ".", seed: int = 37) -> str:
    """Per-multiplicity EVD quantile table (multiEVD,
    src/multiEVD.cpp:99-190): for each simulation, collect heights at the
    full multiplicity, then repeatedly discard a random sequence and
    project down, collecting heights at each multiplicity >= 2."""
    import os

    from mauvealigner_tpu_torch.core.interval import IntervalList
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records

    rng = np.random.default_rng(seed)
    lrh_by_mult: dict = {}
    n_sims = 0
    seq_count = 0
    for run in range(run_count):
        aln = os.path.join(directory, f"alignjob.{run}", "evolved.dat")
        seqs = os.path.join(directory, f"alignjob.{run}", "evolved_seqs.fas")
        if not (os.path.exists(aln) and os.path.exists(seqs)):
            continue
        n_sims += 1
        ivl = IntervalList.read_xmfa(aln)
        ivl.genomes = read_fasta_records(seqs)
        seq_count = max(seq_count, ivl.n_seqs)
        proj = list(range(ivl.n_seqs))
        cur = ivl
        for mult in range(ivl.n_seqs, 1, -1):
            lrh_by_mult.setdefault(mult, []).extend(
                local_record_heights(cur).tolist()
            )
            if mult == 2:
                break
            disc = int(rng.integers(0, len(proj)))
            del proj[disc]
            cur = ivl.projection(proj)
    lines = [f"Total number of simulations: {n_sims}"]
    for mult in range(2, seq_count + 1):
        h = np.array(lrh_by_mult.get(mult, []))
        lines.append(f"multiplicity {mult}:")
        lines.append(quantile_summary(h, n_sims).rstrip())
    return "\n".join(lines) + "\n"


def merge_evd_results(results: Sequence[EvdResult]) -> EvdResult:
    """Aggregate per-job EVD runs (multiEVD over alignjob directories,
    src/multiEVD.cpp:104-105)."""
    results = [r for r in results if r.n_excursions > 0]
    if not results:
        return EvdResult(0, 0.0, 0.0, 0.0, 0.0)
    n = sum(r.n_excursions for r in results)
    mean = sum(r.mean_height * r.n_excursions for r in results) / n
    mx = max(r.max_height for r in results)
    lam = sum(r.gumbel_lambda * r.n_excursions for r in results) / n
    mu = sum(r.gumbel_mu * r.n_excursions for r in results) / n
    return EvdResult(n, mean, mx, lam, mu)


def significance_threshold(result: EvdResult, p_value: float = 0.01) -> float:
    """Score above which an excursion is significant at the given p-value."""
    if result.gumbel_lambda <= 0:
        return float("inf")
    return result.gumbel_mu - math.log(-math.log(1 - p_value)) / result.gumbel_lambda
