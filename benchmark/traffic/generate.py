"""The one generator of the benchmark's inputs: genomes with their truths.

A traffic file (traffic/<name>.json) and a configuration file
(configs/<name>.json) together say what to make; this module makes it from
the run's seed, on the host in a few bulk NumPy calls, and writes it as FASTA.

Shapes it can make:

- ``descendants``: a random ancestor of ``genome_length`` bases and one
  descendant per entry of ``branches``, each at substitution rate ``sub`` and
  insertion and deletion rates ``indel`` each (indel lengths 1 + Poisson(3)),
  with ``inversions`` large reverse-complemented stretches.  The truth of each
  descendant is its position map: for every ancestor position (1-based), the
  signed descendant position it is homologous to, 0 where it was deleted.
- ``draft``: a reference of ``genome_length`` bases and one draft, a
  descendant cut into ``contigs`` pieces at sorted random points in
  [2000, n - 2000), each reverse-complemented with probability ``revcomp``,
  then shuffled.  Its truth is each contig's place in cut order and whether
  it was reverse-complemented.
- ``drafts``: a reference of ``genome_length`` bases and ``count`` drafts,
  each an independent descendant of it cut, flipped and shuffled as for
  ``draft``.  Draft i is drawn from the seed's i-th child generator, so its
  bases do not depend on ``count``.  Files: ``ref.fa``, then ``draft0.fa``
  .. ``draft{count-1}.fa``.

The evolution walk is the one of the program's ``utils/simulate.evolve``
(per ancestor base: a deletion, an insertion before it, or neither, and a
base that is kept may be substituted), with every base's draws made in bulk
instead of one at a time.  Two differences follow: the same seed gives other
genomes than the program's simulator, and a base with an insertion before it
does not draw again (the program's walk redraws it), which changes the rates
by a share of the indel rate.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b
MEAN_INDEL = 3.0


def revcomp(seq: np.ndarray) -> np.ndarray:
    return COMP[seq[::-1]]


@dataclasses.dataclass
class Draft:
    """A draft genome: contig names in file order, their sequences, and for
    each its true rank (cut order) and whether it was reverse-complemented."""

    names: List[str]
    seqs: List[np.ndarray]
    true_rank: np.ndarray
    flipped: np.ndarray
    truth: np.ndarray  # reference position -> signed position in the draft file


@dataclasses.dataclass
class Inputs:
    genomes: List[np.ndarray]          # ASCII bytes, one per input file
    files: List[str]                    # FASTA paths, in command order
    truths: List[np.ndarray]            # position maps of genome 0 -> genome i
    draft: Optional[Draft] = None       # the first draft
    drafts: List[Draft] = dataclasses.field(default_factory=list)  # every draft


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


def evolve(anc: np.ndarray, rng: np.random.Generator, sub: float, ins: float,
           dele: float):
    """(descendant, truth map) of `anc` under the walk described above."""
    n = len(anc)
    r = rng.random(n)
    # events: positions whose draw falls under the deletion or insertion rate
    ev = np.flatnonzero(r < dele + ins)
    ev_len = 1 + rng.poisson(MEAN_INDEL, size=len(ev))
    ins_bases = random_genome(rng, int(ev_len.sum()))
    sub_hit = rng.random(n) < sub
    sub_off = rng.integers(1, 4, size=n)
    keep = np.ones(n, bool)
    pieces_at = []   # (ancestor position, inserted bases) in walk order
    skip_to = 0
    off = 0
    for p, k, is_del in zip(ev.tolist(), ev_len.tolist(), (r[ev] < dele).tolist()):
        if p < skip_to:  # inside an earlier deletion: the walk never drew here
            off += k
            continue
        if is_del:
            k = min(k, n - p)
            keep[p:p + k] = False
            skip_to = p + k
        else:
            pieces_at.append((p, ins_bases[off:off + k]))
        off += k
    # a base inside a deletion is neither kept nor substituted
    codes = np.searchsorted(BASES, anc)
    seq = np.where(sub_hit & keep, BASES[(codes + sub_off) % 4], anc)
    ins_pos = np.array([p for p, _ in pieces_at], np.int64)
    ins_len = np.array([len(b) for _, b in pieces_at], np.int64)
    # descendant position of each kept ancestor base: its rank among kept
    # bases, shifted by the inserted bases placed before it
    shift = np.zeros(n + 1, np.int64)
    np.add.at(shift, ins_pos, ins_len)
    before = np.cumsum(shift)[:n]
    rank = np.cumsum(keep)
    truth = np.zeros(n + 1, np.int64)
    truth[1:][keep] = (rank + before)[keep]
    out = np.empty(int(keep.sum() + ins_len.sum()), np.uint8)
    out[truth[1:][keep] - 1] = seq[keep]
    # an insertion starts after the kept bases and the insertions before it
    kept_before = np.where(ins_pos > 0, rank[np.maximum(ins_pos - 1, 0)], 0)
    ins_start = kept_before + np.cumsum(shift)[ins_pos] - shift[ins_pos]
    for (_, b), start in zip(pieces_at, ins_start.tolist()):
        out[start:start + len(b)] = b
    return out, truth


def invert(desc: np.ndarray, truth: np.ndarray, lo: int, hi: int):
    """Reverse-complement desc[lo..hi] (1-based, inclusive) and its truth."""
    desc = desc.copy()
    desc[lo - 1:hi] = revcomp(desc[lo - 1:hi])
    truth = truth.copy()
    inside = (np.abs(truth) >= lo) & (np.abs(truth) <= hi)
    truth[inside] = -np.sign(truth[inside]) * (lo + hi - np.abs(truth[inside]))
    return desc, truth


def make_descendants(rng, n: int, branches: list):
    anc = random_genome(rng, n)
    genomes, truths = [anc], []
    for br in branches:
        d, t = evolve(anc, rng, br["sub"], br["indel"], br["indel"])
        taken = []
        for _ in range(br.get("inversions", 0)):
            # a stretch of n/80 to n/10 that does not overlap an earlier one
            for _attempt in range(50):
                span = int(rng.integers(n // 80, n // 10))
                lo = int(rng.integers(1000, len(d) - span - 1000))
                if all(lo + span < a or lo > b for a, b in taken):
                    break
            taken.append((lo, lo + span))
            d, t = invert(d, t, lo, lo + span)
        genomes.append(d)
        truths.append(t)
    return genomes, truths


def make_draft(rng, n: int, sub: float, indel: float, contigs: int, p_rev: float):
    ref = random_genome(rng, n)
    return ref, cut_draft(rng, ref, sub, indel, contigs, p_rev)


def cut_draft(rng, ref: np.ndarray, sub: float, indel: float, contigs: int,
              p_rev: float) -> Draft:
    """A descendant of `ref` cut into `contigs` pieces, each reverse-
    complemented with probability `p_rev`, then shuffled."""
    n = len(ref)
    ev, ev_truth = evolve(ref, rng, sub, indel, indel)
    cuts = np.sort(rng.choice(np.arange(2000, n - 2000), size=contigs - 1, replace=False))
    edges = np.concatenate([[0], cuts, [len(ev)]])
    flips = rng.random(contigs) < p_rev
    order = rng.permutation(contigs)
    names = [f"c{i}" for i in order]
    seqs = []
    for i in order:
        chunk = ev[edges[i]:edges[i + 1]]
        seqs.append(revcomp(chunk) if flips[i] else chunk)
    # where each contig starts in the draft file, in cut order
    lens = np.diff(edges)
    file_off = np.zeros(contigs, np.int64)
    file_off[order] = np.concatenate([[0], np.cumsum(lens[order])[:-1]])
    t = ev_truth[1:]
    kept = t > 0
    piece = np.searchsorted(edges, t[kept] - 1, side="right") - 1
    u = t[kept] - 1 - edges[piece]
    pos = np.where(flips[piece], -(file_off[piece] + lens[piece] - u), file_off[piece] + u + 1)
    truth = np.zeros(n + 1, np.int64)
    truth[1:][kept] = pos
    return Draft(names, seqs, order.astype(np.int64), flips[order], truth)


def branches_of(config: dict, traffic: dict) -> list:
    """The branch list of a descendants traffic: given whole, or as a
    linear spread of substitution rates with indels at a share of each."""
    spec = traffic["branches"]
    if isinstance(spec, list):
        return spec
    k = config["genomes"] - 1
    subs = np.linspace(spec["sub_from"], spec["sub_to"], k)
    inv = spec.get("inversions", [0] * k)
    return [{"sub": float(s), "indel": float(s) * spec["indel_share"], "inversions": int(v)}
            for s, v in zip(subs, inv)]


def write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            text = seq.tobytes().decode("ascii")
            for i in range(0, len(text), 80):
                fh.write(text[i:i + 80])
                fh.write("\n")


def draft_inputs(workdir: str, ref: np.ndarray, drafts: List[Draft], names: List[str]) -> Inputs:
    """The reference as ref.fa and each draft under its name, in that order."""
    files = [os.path.join(workdir, f) for f in ["ref.fa", *names]]
    write_fasta(files[0], [("ref", ref)])
    for path, draft in zip(files[1:], drafts):
        write_fasta(path, zip(draft.names, draft.seqs))
    return Inputs([ref] + [np.concatenate(x.seqs) for x in drafts], files,
                  [x.truth for x in drafts], drafts[0], drafts)


def make_inputs(config: dict, traffic: dict, seed: int, workdir: str,
                genome_length: Optional[int] = None) -> Inputs:
    """Make the cell's inputs from `seed` and write them under `workdir`.
    genome_length overrides the configuration's (tests use small ones)."""
    rng = np.random.default_rng(seed % 2**64)
    n = genome_length or config["genome_length"]
    os.makedirs(workdir, exist_ok=True)
    if traffic["shape"] == "descendants":
        genomes, truths = make_descendants(rng, n, branches_of(config, traffic))
        files = []
        for i, g in enumerate(genomes):
            path = os.path.join(workdir, f"g{i}.fa")
            write_fasta(path, [(f"g{i}", g)])
            files.append(path)
        return Inputs(genomes, files, truths)
    if traffic["shape"] == "draft":
        d = traffic["draft"]
        ref, draft = make_draft(rng, n, d["sub"], d["indel"], d["contigs"], d["revcomp"])
        return draft_inputs(workdir, ref, [draft], ["draft.fa"])
    if traffic["shape"] == "drafts":
        d = traffic["drafts"]
        ref = random_genome(rng, n)
        drafts = [cut_draft(np.random.default_rng(child), ref, d["sub"], d["indel"], d["contigs"],
                            d["revcomp"])
                  for child in np.random.SeedSequence(seed % 2**64).spawn(d["count"])]
        return draft_inputs(workdir, ref, drafts, [f"draft{i}.fa" for i in range(d["count"])])
    raise ValueError(f"unknown traffic shape {traffic['shape']!r}")
