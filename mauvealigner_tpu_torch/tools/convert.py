"""Format converters (reference tools, SURVEY.md §2.2 'Format converters').

Each function mirrors one reference tool; the CLI registry in cli.py exposes
them under the reference names.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models.lcb import LCB


# -- xmfa2maf (src/xmfa2maf.cpp) -------------------------------------------

def xmfa2maf(ivs: IntervalList, out: TextIO) -> None:
    """XMFA -> MAF, splitting blocks at contig boundaries
    (applyBreakpoints, src/xmfa2maf.cpp:43; MAF emit :46-80)."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    out.write("##maf version=1 program=mauvealigner_tpu\n")
    for iv in ivs.intervals:
        present = [s for s in range(iv.n_seqs) if iv.starts[s] != 0]
        if not present:
            continue
        # find split columns: cut wherever a sequence's contig index
        # changes between adjacent base-bearing columns (strand-safe —
        # reverse rows walk their contigs in descending coordinates)
        split_cols = set()
        for s in present:
            g = ivs.genomes[s]
            if len(g.contigs) <= 1:
                continue
            pos = _interval_positions(iv, s)
            bounds = g.contig_boundaries()  # starts of each contig
            absp = np.abs(pos)
            nz = np.nonzero(absp)[0]
            if len(nz) < 2:
                continue
            contig_of = np.searchsorted(np.asarray(bounds), absp[nz], side="right")
            change = np.nonzero(contig_of[1:] != contig_of[:-1])[0]
            for ci in change:
                split_cols.add(int(nz[ci + 1]))
        cuts = sorted(split_cols)
        ranges = []
        start = 0
        for c in cuts:
            if c > start:
                ranges.append((start, c))
            start = c
        if start < iv.n_cols:
            ranges.append((start, iv.n_cols))
        for a, b in ranges:
            _write_maf_block(ivs, iv, a, b, out)


def _write_maf_block(ivs: IntervalList, iv: Interval, a: int, b: int, out: TextIO) -> None:
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    lines = []
    for s in range(iv.n_seqs):
        if iv.starts[s] == 0 or not iv.aln[s, a:b].any():
            continue
        g = ivs.genomes[s]
        pos = _interval_positions(iv, s)[a:b]
        nz = pos[pos != 0]
        strand = "+" if nz[0] > 0 else "-"
        size = len(nz)
        text = iv.aligned_text(ivs.genomes, s)[a:b]
        # MAF rows are CONTIG-local (src = file.contig, srcSize = contig
        # length, coords within the contig — src/xmfa2maf.cpp:57-80); the
        # contig-boundary split above guarantees one contig per row
        glob_left = int(np.abs(nz).min())
        ci, local_left = g.global_to_local(glob_left)
        contig = g.contigs[ci]
        src_size = int(contig.length)
        if strand == "+":
            start0 = local_left - 1  # MAF: 0-based
        else:
            # MAF reverse coords count from the end of the + strand
            start0 = src_size - (local_left - 1) - size
        name = (ivs.filenames()[s] or f"seq{s}").replace(" ", "_")
        if len(g.contigs) > 1 or contig.name:
            name = f"{name}.{contig.name or ci}".replace(" ", "_")
        lines.append(f"s {name} {start0} {size} {strand} {src_size} {text}\n")
    if lines:
        out.write("a score=0\n")
        out.writelines(lines)
        out.write("\n")


# -- mfa2xmfa (src/mfa2xmfa.cpp) -------------------------------------------

def mfa2xmfa(aligned_records: Sequence[Genome], out: TextIO) -> IntervalList:
    """Aligned MFA (rows of equal width incl. gaps) -> XMFA."""
    widths = {len(r) for r in aligned_records}
    if len(widths) != 1:
        raise ValueError("MFA rows have unequal lengths")
    n = len(aligned_records)
    width = widths.pop()
    aln = np.zeros((n, width), bool)
    genomes = []
    for i, rec in enumerate(aligned_records):
        row = rec.seq != ord("-")
        aln[i] = row
        genomes.append(Genome(rec.seq[row], name=rec.name))
    starts = np.where(aln.any(axis=1), 1, 0).astype(np.int64)
    ivl = IntervalList(genomes=genomes, intervals=[Interval(starts, aln)])
    ivl.write_xmfa(out)
    return ivl


# -- toMultiFastA (src/toMultiFastA.cpp) -----------------------------------

def to_multi_fasta(ivs: IntervalList, prefix: str, width: int = 80) -> List[str]:
    """One gapped MFA file per interval, named `<base>.lcb_<i>` as the
    reference does (src/toMultiFastA.cpp:32-33); returns file names."""
    names = []
    for k, iv in enumerate(ivs.intervals):
        fname = f"{prefix}.lcb_{k}"
        with open(fname, "w") as fh:
            for s in range(iv.n_seqs):
                if iv.starts[s] == 0:
                    continue
                fh.write(f">{ivs.filenames()[s]}\n")
                text = iv.aligned_text(ivs.genomes, s)
                for c in range(0, len(text), width):
                    fh.write(text[c : c + width] + "\n")
        names.append(fname)
    return names


# -- toRawSequence / multiToRawSequence ------------------------------------

def to_raw_sequence(genome: Genome, out_path: str) -> None:
    genome.seq.tofile(out_path)


def multi_to_raw_sequence(genomes: Sequence[Genome], out_paths: Sequence[str]) -> None:
    for g, p in zip(genomes, out_paths):
        g.seq.tofile(p)


# -- toGBKsequence (src/toGBKsequence.cpp) ---------------------------------

def to_gbk_sequence(genome: Genome, out: TextIO) -> None:
    """Minimal GenBank writer."""
    for c in genome.contigs:
        out.write(
            f"LOCUS       {c.name.split()[0]:<16} {c.length} bp    DNA     linear   UNK\n"
        )
        out.write(f"DEFINITION  {c.name}\n")
        out.write("ORIGIN\n")
        seq = genome.seq[c.offset : c.offset + c.length].tobytes().decode().lower()
        for i in range(0, len(seq), 60):
            chunk = seq[i : i + 60]
            groups = " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10))
            out.write(f"{i + 1:>9} {groups}\n")
        out.write("//\n")


# -- signed permutation outputs --------------------------------------------

def lcb_signed_permutations(lcbs: Sequence[LCB]) -> List[List[int]]:
    """Per genome: LCB ids (1-based) in genome order, negative = inverted
    (the permutation emission of SetPermutationOutput,
    src/mauveAligner.cpp:678-686)."""
    if not lcbs:
        return []
    n_seqs = len(lcbs[0].lefts)
    perms = []
    for g in range(n_seqs):
        items = []
        for k, lcb in enumerate(lcbs):
            if lcb.lefts[g] == 0:
                continue
            items.append((int(lcb.lefts[g]), int(lcb.strands[g]) * (k + 1)))
        items.sort()
        perms.append([v for _, v in items])
    return perms


def to_grimm_format(
    lcbs: Sequence[LCB],
    names: Sequence[str],
    out: TextIO,
    chr_bounds: Optional[Sequence[Sequence[int]]] = None,
) -> None:
    """GRIMM signed-permutation input (src/toGrimmFormat.cpp:17).

    chr_bounds (optional): per genome, CUMULATIVE chromosome end
    coordinates; a ` $` chromosome separator is emitted whenever the walk
    crosses one (multichromosomal GRIMM, :68-72)."""
    perms = lcb_signed_permutations(lcbs)
    for g, perm in enumerate(perms):
        name = names[g] if g < len(names) else f"genome{g}"
        out.write(f">{name}\n")
        if not chr_bounds or g >= len(chr_bounds) or not chr_bounds[g]:
            out.write(" ".join(str(v) for v in perm) + " $\n")
            continue
        # walk LCBs in genome order, splitting at chromosome bounds; the
        # permutation is ordered by left end, so recover each id's left end
        lefts = {}
        for k, lcb in enumerate(lcbs):
            if lcb.lefts[g] != 0:
                lefts[(k + 1)] = int(lcb.lefts[g])
        bounds = list(chr_bounds[g])
        cur_chr = 0
        parts: List[str] = []
        for v in perm:
            while cur_chr < len(bounds) - 1 and lefts[abs(v)] > bounds[cur_chr]:
                parts.append("$\n")
                cur_chr += 1
            parts.append(str(v))
        text = ""
        for p in parts:
            if p.endswith("\n"):
                text = text.rstrip(" ") + " " + p
            else:
                text += p + " "
        out.write(text.rstrip(" ") + " $\n")


def make_badger_matrix(
    ivs: IntervalList, out: TextIO, coords_out: Optional[TextIO] = None
) -> None:
    """BADGER permutation matrix + LCB coordinate file
    (src/makeBadgerMatrix.cpp:30-103).

    Badger rows: `<seq name>,<±id>,...` — blocks in that genome's
    coordinate order, id = 1-based input block index, sign relative to the
    block's FIRST PRESENT sequence's orientation (:97-98); multiplicity-1
    blocks skipped.  Coordinate file: per surviving block, per genome,
    signed leftend/rightend (both negated on reverse strand, :81-82)."""
    names = ivs.filenames()
    n_seqs = ivs.n_seqs
    blocks = [
        (k, iv) for k, iv in enumerate(ivs.intervals) if iv.multiplicity() >= 2
    ]
    if coords_out is not None:
        coords_out.write(
            "\t".join(f"seq{g}_leftend\tseq{g}_rightend" for g in range(n_seqs))
            + "\n"
        )
        for _, iv in blocks:
            cells = []
            lefts, rights = iv.lefts(), iv.rights()
            for g in range(n_seqs):
                sign = -1 if iv.starts[g] < 0 else 1
                cells.append(str(sign * int(lefts[g])))
                cells.append(str(sign * int(rights[g])))
            coords_out.write("\t".join(cells) + "\n")
    for g in range(n_seqs):
        name = names[g] if g < len(names) and names[g] else f"seq{g}"
        row = [name]
        order = sorted(
            (x for x in range(len(blocks)) if blocks[x][1].starts[g] != 0),
            key=lambda x: abs(int(blocks[x][1].starts[g])),
        )
        for x in order:
            k, iv = blocks[x]
            first = next(s for s in range(iv.n_seqs) if iv.starts[s] != 0)
            rel = int(np.sign(iv.starts[g])) * int(np.sign(iv.starts[first]))
            row.append(f"{'-' if rel < 0 else ''}{k + 1}")
        out.write(",".join(row) + "\n")


def make_mc4_matrix(ivs: IntervalList, out: TextIO) -> None:
    """MC4 matrix (src/makeMc4Matrix.cpp:50-96): N-way blocks only, ids
    assigned in genome-0 order with orientations normalized so genome 0 is
    forward; per genome, a doubled-permutation row
    `<name>,0,<2k-1,2k | 2k,2k-1>...,0` (forward | reverse) followed by a
    `standard,<±id>...` row, blocks in that genome's coordinate order."""
    names = ivs.filenames()
    n_seqs = ivs.n_seqs
    blocks = [iv for iv in ivs.intervals if iv.multiplicity() == n_seqs]
    order0 = sorted(range(len(blocks)), key=lambda x: abs(int(blocks[x].starts[0])))
    ids = {x: rank + 1 for rank, x in enumerate(order0)}
    sign0 = {x: int(np.sign(blocks[x].starts[0])) for x in range(len(blocks))}
    for g in range(n_seqs):
        name = names[g] if g < len(names) and names[g] else f"seq{g}"
        orderg = sorted(range(len(blocks)), key=lambda x: abs(int(blocks[x].starts[g])))
        doubled = [0]
        standard = []
        for x in orderg:
            k = ids[x]
            rel = int(np.sign(blocks[x].starts[g])) * sign0[x]
            if rel >= 0:
                doubled += [2 * k - 1, 2 * k]
            else:
                doubled += [2 * k, 2 * k - 1]
            standard.append(f"{'-' if rel < 0 else ''}{k}")
        doubled.append(0)
        out.write(name + "," + ",".join(str(v) for v in doubled) + "\n")
        out.write("standard," + ",".join(standard) + "\n")


def _alphabet_id(counter: int) -> str:
    """Four-letter base-26 suffix (getAlphabetID,
    src/toEvoHighwayFormat.cpp:21-32)."""
    rval = list("aaaa")
    i = 3
    while i > 0 and counter > 0:
        rval[i] = chr(counter % 26 + 97)
        counter //= 26
        i -= 1
    return "".join(rval)


def _chromosome_of(bounds: Sequence[int], pos: int) -> int:
    """Chromosome index of a 1-based coordinate: first cumulative bound
    >= pos, so a chromosome's LAST base stays in that chromosome —
    consistent with the species-side `pos > bound` walk.  (The
    reference's getChromosome uses strictly-greater on the same 1-based
    coords, src/toEvoHighwayFormat.cpp:11-19, pushing a boundary base
    into the next chromosome with local coordinate 0 — off-by-one, not
    replicated.)"""
    for i, b in enumerate(bounds):
        if b >= pos:
            return i
    return len(bounds)


def to_evo_highway_format(
    lcbs: Sequence[LCB],
    names: Sequence[str],
    seq_lengths: Sequence[int],
    out: TextIO,
    ref_id: int = 0,
    chr_bounds: Optional[Sequence[Sequence[int]]] = None,
) -> None:
    """EvoHighway synteny-block rows (src/toEvoHighwayFormat.cpp:82-144):
    one TSV row per LCB per non-reference genome, walked in that genome's
    coordinate order — refname, ref chromosome (1-based), ref interval
    (chromosome-local), species chromosome + base-26 block suffix, species
    interval (chromosome-local), strand as [-]1, species name, LCB id."""
    if chr_bounds is None:
        chr_bounds = [[int(l)] for l in seq_lengths]
    n_seqs = len(lcbs[0].lefts) if lcbs else 0
    ref_name = names[ref_id] if ref_id < len(names) else f"genome{ref_id}"
    ref_bounds = chr_bounds[ref_id]
    for g in range(n_seqs):
        if g == ref_id:
            continue
        order = sorted(
            (k for k in range(len(lcbs))
             if lcbs[k].lefts[g] != 0 and lcbs[k].lefts[ref_id] != 0),
            key=lambda k: int(lcbs[k].lefts[g]),
        )
        cur_chr = 0
        counter = 0
        bounds = chr_bounds[g]
        gname = names[g] if g < len(names) else f"genome{g}"
        for k in order:
            lcb = lcbs[k]
            while cur_chr < len(bounds) - 1 and int(lcb.lefts[g]) > bounds[cur_chr]:
                cur_chr += 1
                counter = 0
            ref_chr = _chromosome_of(ref_bounds, int(lcb.lefts[ref_id]))
            ref_off = ref_bounds[ref_chr - 1] if ref_chr > 0 else 0
            sp_off = bounds[cur_chr - 1] if cur_chr > 0 else 0
            strand = "-1" if int(lcb.strands[ref_id]) * int(lcb.strands[g]) < 0 else "1"
            out.write(
                f"{ref_name}\t{ref_chr + 1}"
                f"\t{int(lcb.lefts[ref_id]) - ref_off}"
                f"\t{int(lcb.rights[ref_id]) - ref_off}"
                f"\t{cur_chr + 1}{_alphabet_id(counter)}"
                f"\t{int(lcb.lefts[g]) - sp_off}"
                f"\t{int(lcb.rights[g]) - sp_off}"
                f"\t{strand}\t{gname}\t{k + 1}\n"
            )
            counter += 1


# -- per-LCB alternative alignment formats (gnAlignedSequences output,
#    src/mauveAligner.cpp:764-781) ------------------------------------------

def write_clustal(ivs: IntervalList, out: TextIO, width: int = 60) -> None:
    out.write("CLUSTAL W multiple sequence alignment (mauvealigner-tpu)\n\n")
    names = [n.replace(" ", "_")[:24] or f"seq{i}" for i, n in enumerate(ivs.filenames())]
    for iv in ivs.intervals:
        texts = {
            s: iv.aligned_text(ivs.genomes, s)
            for s in range(iv.n_seqs)
            if iv.starts[s] != 0
        }
        if not texts:
            continue
        n_cols = iv.n_cols
        for off in range(0, n_cols, width):
            for s, text in texts.items():
                out.write(f"{names[s]:<25}{text[off : off + width]}\n")
            out.write("\n")
        out.write("\n")


def write_phylip(ivs: IntervalList, out: TextIO) -> None:
    """Sequential PHYLIP of the concatenated multiplicity>=2 blocks."""
    multi = [iv for iv in ivs.intervals if iv.multiplicity() >= 2]
    if not multi:
        out.write("0 0\n")
        return
    n = ivs.n_seqs
    rows = ["" for _ in range(n)]
    for iv in multi:
        for s in range(n):
            rows[s] += iv.aligned_text(ivs.genomes, s)
    out.write(f"{n} {len(rows[0])}\n")
    names = [n_.replace(" ", "_")[:10] or f"seq{i}" for i, n_ in enumerate(ivs.filenames())]
    for s in range(n):
        out.write(f"{names[s]:<10}{rows[s]}\n")


# -- gappiness (src/gappiness.cpp) -----------------------------------------

def gappiness(ivs: IntervalList) -> float:
    """Fraction of gap cells among all cells of participating rows."""
    cells = gaps = 0
    for iv in ivs.intervals:
        for s in range(iv.n_seqs):
            if iv.starts[s] == 0:
                continue
            cells += iv.n_cols
            gaps += iv.n_cols - int(iv.aln[s].sum())
    return gaps / cells if cells else 0.0


def gappiness_report(rows: Sequence[Genome], out: TextIO) -> None:
    """The reference gappiness report over an aligned MFA
    (src/gappiness.cpp:10-53): aln_length, per-seq ungapped lengths,
    avg_seq_len, gappiness = aln_length/avg_seq_len, mean pairwise
    percent_id over both-base columns."""
    if not rows:
        return
    width = len(rows[0].seq)
    if any(len(r.seq) != width for r in rows):
        raise ValueError("gappiness expects an ALIGNED MFA (equal row widths)")
    out.write(f"aln_length\t{width}\n")
    mats = np.stack([r.seq for r in rows])
    base = mats != ord("-")
    lens = base.sum(axis=1)
    for i, l in enumerate(lens):
        out.write(f"seq{i}_len\t{int(l)}\n")
    avg = float(lens.mean())
    out.write(f"avg_seq_len\t{avg:g}\n")
    out.write(f"gappiness\t{width / avg:g}\n")
    upper = np.where((mats >= ord("a")) & (mats <= ord("z")), mats - 32, mats)
    total_id = total_possible = 0
    for i in range(len(rows)):
        for j in range(i + 1, len(rows)):
            both = base[i] & base[j]
            total_possible += int(both.sum())
            total_id += int((both & (upper[i] == upper[j])).sum())
    pid = total_id / total_possible if total_possible else 0.0
    out.write(f"percent_id\t{pid:g}\n")


# -- countInPlaceInversions (src/countInPlaceInversions.cpp) ---------------

def find_in_place_inversions(
    lcbs: Sequence[LCB],
) -> List[Tuple[int, int, int, int]]:
    """In-place inversions (src/countInPlaceInversions.cpp:35-67): an LCB
    whose left AND right neighbor LCBs are identical across every genome,
    reported once per minority-orientation sequence as
    (lcb index, seq, signed lend, signed rend).

    The reference compares the forward count against the sequence loop
    index (`forward_count * 2 > seqI`, :57-60) — an evident bug; the
    intended majority test against seq_count is implemented instead."""
    if not lcbs:
        return []
    n_seqs = len(lcbs[0].lefts)
    # per genome: neighbor ids in coordinate order (-1 at the ends)
    nbrs: List[dict] = []
    for g in range(n_seqs):
        order = sorted(
            (k for k in range(len(lcbs)) if lcbs[k].lefts[g] != 0),
            key=lambda k: int(lcbs[k].lefts[g]),
        )
        d = {}
        for i, k in enumerate(order):
            d[k] = (order[i - 1] if i > 0 else -1,
                    order[i + 1] if i + 1 < len(order) else -1)
        nbrs.append(d)
    out: List[Tuple[int, int, int, int]] = []
    for k, lcb in enumerate(lcbs):
        if any(lcb.lefts[g] == 0 for g in range(n_seqs)):
            continue
        if any(nbrs[g].get(k) != nbrs[0].get(k) for g in range(1, n_seqs)):
            continue
        forward = sum(1 for g in range(n_seqs) if lcb.strands[g] > 0)
        for g in range(n_seqs):
            minority = (
                (forward * 2 > n_seqs and lcb.strands[g] < 0)
                or (forward * 2 < n_seqs and lcb.strands[g] > 0)
            )
            if minority:
                sign = int(lcb.strands[g]) or 1
                out.append((k, g, sign * int(lcb.lefts[g]), sign * int(lcb.rights[g])))
    return out


def count_in_place_inversions(lcbs: Sequence[LCB]) -> int:
    """Number of distinct in-place-inverted LCBs."""
    return len({k for k, _, _, _ in find_in_place_inversions(lcbs)})
