"""Sequence evolution simulator with known-truth alignments.

The reference validates aligners against simulated genomes with known
correct alignments (scoreAlignment's "correct alignment" input,
src/scoreAlignment.cpp:102-113).  This module provides that simulator:
it evolves an ancestor by substitutions/indels/inversions and emits the
true pairwise alignment as an IntervalList (one interval per collinear
segment, strand-aware).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import Contig, Genome, revcomp_ascii

_BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng: np.random.Generator, n: int, name: str = "anc") -> Genome:
    return Genome(_BASES[rng.integers(0, 4, size=n)], name=name)


def evolve(
    ancestor: Genome,
    rng: np.random.Generator,
    sub_rate: float = 0.01,
    ins_rate: float = 0.002,
    del_rate: float = 0.002,
    mean_indel: float = 3.0,
    name: str = "der",
) -> Tuple[Genome, IntervalList]:
    """Evolve a collinear descendant; returns (derived, truth alignment).

    The truth IntervalList covers the two genomes [ancestor, derived] with a
    single collinear interval.

    The JAX package's per-base walk, with the same draws in the same order
    (so the same genomes from the same generator): per ancestor base one
    uniform picks deletion, insertion or a kept base, and a kept base draws
    again for a substitution.  The walk records only the events; the
    descendant and the alignment rows are assembled from them afterwards,
    in slices, instead of one small array per base.
    """
    anc = ancestor.seq
    n = len(anc)
    rand = rng.random
    indel_rate = del_rate + ins_rate
    subs = []    # (position, offset draw) of each substituted base
    events = []  # (position, length, inserted bases or None for a deletion)
    i = 0
    while i < n:
        r = rand()
        if r < del_rate:
            k = min(1 + rng.poisson(mean_indel), n - i)
            events.append((i, k, None))
            i += k
        elif r < indel_rate:
            k = 1 + rng.poisson(mean_indel)
            events.append((i, k, _BASES[rng.integers(0, 4, size=k)]))
        else:
            if rand() < sub_rate:
                subs.append((i, rng.integers(1, 4)))
            i += 1
    seq = anc.copy()
    if subs:
        pos, off = (np.array(x, np.int64) for x in zip(*subs))
        seq[pos] = _BASES[(np.searchsorted(_BASES, anc[pos]) + off) % 4]
    out: List[np.ndarray] = []
    row_a: List[np.ndarray] = []
    row_d: List[np.ndarray] = []

    def block(bases, k, in_anc, in_der):
        if bases is not None:
            out.append(bases)
        row_a.append(np.full(k, in_anc))
        row_d.append(np.full(k, in_der))

    cur = 0  # first ancestor base not yet placed
    for pos, k, ins in events:
        if pos > cur:
            block(seq[cur:pos], pos - cur, True, True)
        if ins is None:
            block(None, k, True, False)
            cur = pos + k
        else:
            block(ins, k, False, True)
            cur = pos
    if n > cur:
        block(seq[cur:], n - cur, True, True)
    derived = Genome(np.concatenate(out) if out else np.zeros(0, np.uint8), name=name)
    aln = np.stack([np.concatenate(row_a), np.concatenate(row_d)])
    iv = Interval(np.array([1, 1], np.int64), aln)
    truth = IntervalList(genomes=[ancestor, derived], intervals=[iv])
    return derived, truth


def apply_inversion(genome: Genome, left: int, right: int) -> Genome:
    """Return a copy with [left, right] (1-based inclusive) reverse-complemented."""
    seq = genome.seq.copy()
    seq[left - 1 : right] = revcomp_ascii(seq[left - 1 : right])
    return Genome(seq, name=genome.name + "_inv")


def apply_inversion_with_truth(
    derived: Genome, truth: IntervalList, left: int, right: int
) -> Tuple[Genome, IntervalList]:
    """Reverse-complement derived[left..right] (1-based inclusive) AND update
    the truth alignment, so the simulation oracle survives rearrangements.

    The collinear truth interval splits at the columns holding derived
    positions `left` and `right`; the middle block's derived row flips to
    the negative strand with start -left.  The boolean pattern is unchanged:
    a negative-strand row consumes positions right-to-left as columns
    advance, which is exactly the new homology map
    new_derived[(left+right)-d] = revcomp(old_derived[d]).

    `truth` must be a 2-genome collinear truth from evolve() whose interval
    may already contain earlier inversion splits; the inverted range must
    fall entirely inside one forward-strand piece.
    """
    g2 = apply_inversion(derived, left, right)
    new_intervals: List[Interval] = []
    handled = False
    for iv in truth.intervals:
        s = int(iv.starts[1])
        row = iv.aln[1]
        length = int(row.sum())
        if s <= 0 or not (s <= left and right <= s + length - 1):
            new_intervals.append(iv)
            continue
        assert not handled, "inversion range spans multiple truth pieces"
        handled = True
        cols_with = np.nonzero(row)[0]
        c0 = int(cols_with[left - s])
        c1 = int(cols_with[right - s])
        if c0 > 0:
            new_intervals.append(iv.column_slice(0, c0))
        mid = iv.column_slice(c0, c1 + 1)
        mid.starts[1] = -left
        new_intervals.append(mid)
        if c1 + 1 < iv.n_cols:
            new_intervals.append(iv.column_slice(c1 + 1, iv.n_cols))
    if not handled:
        raise ValueError("inversion range not covered by a forward truth piece")
    out = IntervalList(genomes=[truth.genomes[0], g2], intervals=new_intervals)
    return g2, out


def enterobacteria_like(size: int, k: int, max_rate: float = 0.08, seed: int = 37):
    """k genomes of about `size` bases at enterobacteria-like divergence:
    an ancestor and k-1 descendants with per-branch substitution rates
    spread evenly over 3%..max_rate (indels at a tenth of that), half of
    them carrying one or two large inversions.  Returns (genomes, truths),
    truths[i] the collinear-with-inversions truth of the pair (ancestor,
    descendant i+1).  The generator of scripts/bench_enterobacteria.py
    (same seed, same draws), without its on-disk cache."""
    rng = np.random.default_rng(seed)
    anc = random_genome(rng, size, name="anc")
    genomes, truths = [anc], []
    # pairwise divergence between two descendants ~ sum of branch rates
    rates = np.linspace(0.03, max_rate, k - 1)
    for i, s in enumerate(rates):
        d, t = evolve(
            anc, rng, sub_rate=float(s), ins_rate=float(s) / 10,
            del_rate=float(s) / 10, name=f"d{i}",
        )
        if i % 2 == 1:  # half the genomes carry 1-2 large inversions
            for _ in range(1 + (i % 3 == 1)):
                # redraw until the range sits inside one forward truth piece
                # (a second inversion must not overlap the first)
                for _attempt in range(20):
                    span = int(rng.integers(size // 80, size // 10))
                    lo = int(rng.integers(1000, len(d) - span - 1000))
                    try:
                        d, t = apply_inversion_with_truth(d, t, lo, lo + span)
                        break
                    except ValueError:
                        continue
        genomes.append(d)
        truths.append(t)
    return genomes, truths


def planted_repeats(spacer_scale: int = 1, seed: int = 37) -> Genome:
    """The repeat-family genome of scripts/bench_configs.py config4 (same
    seed, same draws): a 30,000 bp spacer, then 8 copies of one 600 bp unit,
    each followed by a 20,000 bp spacer, and after every other copy a 300 bp
    unit and a 10,000 bp spacer: 236,000 bp.  spacer_scale multiplies every
    spacer's length (4 gives 926,000 bp with the same planted families)."""
    rng = np.random.default_rng(seed)
    parts = [random_genome(rng, 30_000 * spacer_scale).seq]
    unit1 = random_genome(rng, 600).seq
    unit2 = random_genome(rng, 300).seq
    for i in range(8):
        parts.append(unit1.copy())
        parts.append(random_genome(rng, 20_000 * spacer_scale).seq)
        if i % 2 == 0:
            parts.append(unit2.copy())
            parts.append(random_genome(rng, 10_000 * spacer_scale).seq)
    return Genome(np.concatenate(parts), name="repeats")


def draft_genomes(n: int, k: int, n_contigs: int) -> Tuple[Genome, List[Genome]]:
    """The draft-genome workflow's inputs, as scripts/bench_configs.py
    config5 draws them (seed 37, the same draws in the same order): a
    random reference of n bases named "ref", then per draft d0 .. d{k-2} a
    descendant (sub 0.01, indel 0.0005) cut at n_contigs - 1 sorted
    distinct points of [2000, n - 2000), each piece reverse-complemented
    with probability 0.4, and the pieces shuffled into a multi-contig
    genome (contig names d<i>_c<j> in cut order).  Config 5 is (150_000,
    8, 6).  Returns (reference, drafts)."""
    rng = np.random.default_rng(37)
    ref = random_genome(rng, n, name="ref")

    def make_draft(evolved: Genome, name: str) -> Genome:
        cuts = np.sort(
            rng.choice(np.arange(2000, n - 2000), size=n_contigs - 1, replace=False)
        )
        edges = np.concatenate([[0], cuts, [len(evolved)]])
        pieces = []
        for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            chunk = evolved.seq[a:b]
            if rng.random() < 0.4:
                chunk = revcomp_ascii(chunk)
            pieces.append((f"{name}_c{i}", chunk))
        contigs, parts, off = [], [], 0
        for idx in rng.permutation(len(pieces)):
            cname, chunk = pieces[idx]
            contigs.append(Contig(cname, len(chunk), off))
            parts.append(chunk)
            off += len(chunk)
        return Genome(np.concatenate(parts), contigs=contigs, name=name)

    drafts = []
    for i in range(k - 1):
        ev, _ = evolve(ref, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
        drafts.append(make_draft(ev, f"d{i}"))
    return ref, drafts
