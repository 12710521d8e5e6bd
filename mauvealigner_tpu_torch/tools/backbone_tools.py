"""Backbone / island analysis tools (SURVEY.md §2.2 'Backbone / island').

Function-per-reference-tool over backbone coordinate rows (.backbone files,
one signed [left,right] pair per sequence per row).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, TextIO, Tuple

import numpy as np

from mauvealigner_tpu_torch.core.interval import IntervalList
from mauvealigner_tpu_torch.genome.sequence import Genome


# -- bbFilter (src/bbFilter.cpp:47-53) --------------------------------------

def bb_filter(
    rows: Sequence[np.ndarray],
    min_length: int = 20,
    independence_distance: int = 0,
) -> List[np.ndarray]:
    """Drop segments whose AVERAGE member-sequence length (integer
    division) is below min_length (ShorterThan, src/bbFilter.cpp:21-37).
    The independence distance is enforced when nonzero; note the reference
    parses the argument but its check is dead code (check_independence is
    hard-coded false, src/bbFilter.cpp:61,142) — pass 0 for strict
    reference behavior."""
    out: List[np.ndarray] = []
    last_end: Optional[np.ndarray] = None
    for r in rows:
        members = r[::2] != 0
        lens = np.abs(r[1::2]) - np.abs(r[::2]) + 1
        if not members.any():
            continue
        if int(lens[members].sum()) // int(members.sum()) < min_length:
            continue
        if independence_distance and last_end is not None:
            gaps = np.abs(r[::2]) - last_end
            if members.any() and np.nanmin(gaps[members].astype(float)) < independence_distance:
                continue
        out.append(r)
        last_end = np.abs(r[1::2])
    return out


def presence_absence_matrix(
    rows: Sequence[np.ndarray], n_seqs: int, informative_only: bool = False
) -> np.ndarray:
    """Binary segment-by-genome presence matrix (BEAST/GenoPlast input).

    With informative_only, rows present in every genome or in none are
    dropped (the reference's good_bb = ~(nway | nunya),
    src/bbFilter.cpp:117-140): constant site patterns carry no signal."""
    m = np.zeros((len(rows), n_seqs), np.int8)
    for i, r in enumerate(rows):
        m[i] = (r[::2] != 0).astype(np.int8)
    if informative_only and len(m):
        keep = (m.sum(axis=1) > 0) & (m.sum(axis=1) < n_seqs)
        m = m[keep]
    return m


def add_unique_segments_rows(rows: List[np.ndarray]) -> List[np.ndarray]:
    """addUniqueSegments over bare backbone rows (src/bbFilter.cpp:90):
    per genome, append regions covered by no row as single-genome
    segments; genome lengths are inferred from the maximum coordinate."""
    if not rows:
        return rows
    n = len(rows[0]) // 2
    out = list(rows)
    for s in range(n):
        glen = max((int(np.abs(r[2 * s + 1])) for r in rows), default=0)
        if glen == 0:
            continue
        covered = np.zeros(glen + 2, bool)
        for r in rows:
            l, rr = abs(int(r[2 * s])), abs(int(r[2 * s + 1]))
            if l > 0:
                covered[l : rr + 1] = True
        free = ~covered[1 : glen + 1]
        d = np.diff(np.concatenate([[0], free.view(np.int8), [0]]))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0]
        for a, b in zip(starts, ends):
            row = np.zeros(2 * n, np.int64)
            row[2 * s] = a
            row[2 * s + 1] = b
            out.append(row)
    return out


def write_beast_xml(matrix: np.ndarray, names: Sequence[str], out: TextIO) -> None:
    """Minimal BEAST-style binary alignment block (bbFilter 'beast' mode)."""
    out.write("<beast>\n  <alignment dataType=\"binary\">\n")
    for j in range(matrix.shape[1]):
        name = names[j] if j < len(names) else f"seq{j}"
        chars = "".join(str(int(v)) for v in matrix[:, j])
        out.write(f'    <sequence taxon="{name}">{chars}</sequence>\n')
    out.write("  </alignment>\n</beast>\n")


def write_genoplast(matrix: np.ndarray, names: Sequence[str], out: TextIO) -> None:
    out.write("\t".join(names) + "\n")
    for i in range(matrix.shape[0]):
        out.write("\t".join(str(int(v)) for v in matrix[i]) + "\n")


# -- backbone_global_to_local (src/backbone_global_to_local.cpp:13) ---------

def backbone_global_to_local(
    rows: Sequence[np.ndarray], genomes: Sequence[Genome]
) -> List[List[Tuple[int, int, int, int]]]:
    """Rewrite backbone coords as per-seq
    (left_contig, local_left, right_contig, local_right) — each endpoint
    translated within its OWN contig, exactly as the reference emits
    `c1:start<TAB>c2:end` without reconciling a contig-spanning segment
    (src/backbone_global_to_local.cpp:37-58)."""
    out = []
    for r in rows:
        row_entries: List[Tuple[int, int, int, int]] = []
        for s, g in enumerate(genomes):
            l, rr = int(abs(r[2 * s])), int(abs(r[2 * s + 1]))
            if l == 0:
                row_entries.append((0, 0, 0, 0))
                continue
            ci, lloc = g.global_to_local(l)
            cj, rloc = g.global_to_local(min(rr, len(g)))
            row_entries.append((ci, lloc, cj, rloc))
        out.append(row_entries)
    return out


# -- calculateBackboneCoverage (src/calculateBackboneCoverage.cpp:22) -------

def backbone_coverage(rows: Sequence[np.ndarray], seq_lengths: Sequence[int]) -> np.ndarray:
    """Fraction of each genome covered by backbone segments."""
    n = len(seq_lengths)
    out = np.zeros(n)
    for s in range(n):
        if seq_lengths[s] == 0:
            continue
        covered = np.zeros(seq_lengths[s] + 2, bool)
        for r in rows:
            l, rr = int(abs(r[2 * s])), int(abs(r[2 * s + 1]))
            if l:
                covered[l : rr + 1] = True
        out[s] = covered[1 : seq_lengths[s] + 1].mean()
    return out


# -- extractBackbone (src/extractBackbone.cpp:21) ---------------------------

def extract_backbone_sequences(
    rows: Sequence[np.ndarray], genomes: Sequence[Genome]
) -> List[List[str]]:
    """Per row: the segment's sequence in every member genome."""
    out = []
    for r in rows:
        seqs = []
        for s, g in enumerate(genomes):
            l, rr = int(r[2 * s]), int(r[2 * s + 1])
            if l == 0:
                seqs.append("")
                continue
            length = abs(rr) - abs(l) + 1
            seqs.append(g.subseq_signed(l if l > 0 else -abs(l), length))
        out.append(seqs)
    return out


def write_backbone_mfa(
    rows: Sequence[np.ndarray], genomes: Sequence[Genome], out: TextIO, width: int = 80
) -> None:
    """createBackboneMFA: concatenated backbone regions per genome as MFA
    (src/createBackboneMFA.cpp:14)."""
    n = len(genomes)
    for s in range(n):
        chunks = []
        for r in rows:
            l, rr = int(r[2 * s]), int(r[2 * s + 1])
            if l == 0:
                continue
            length = abs(rr) - abs(l) + 1
            chunks.append(genomes[s].subseq_signed(l, length))
        out.write(f">{genomes[s].name or f'seq{s}'}\n")
        text = "".join(chunks)
        for c in range(0, len(text), width):
            out.write(text[c : c + width] + "\n")


# -- getOrthologList (src/getOrthologList.cpp:77) ---------------------------

def _overlap(a1: int, a2: int, b1: int, b2: int) -> int:
    """Length of [a1,a2] ∩ [b1,b2] (0 when disjoint)."""
    lo, hi = max(a1, b1), min(a2, b2)
    return max(hi - lo + 1, 0)


def ortholog_list(
    ivs: IntervalList,
    rows: Sequence[np.ndarray],
    annotated_seq: int = 0,
    output_base: str = "",
) -> List[dict]:
    """Positional ortholog CDS table (src/getOrthologList.cpp:133-313):
    for every CDS of the annotated genome intersecting N-WAY backbone,
    find the interval with the largest CDS∩backbone overlap (multiple
    overlapping intervals mark the gene 'rearranged'), extract the CDS
    column range as a per-gene alignment (written to
    `<output_base>_<id>.fas` when output_base given), and pick the
    best-overlapping CDS in every other genome; a row emits only when
    every genome carries an annotated ortholog CDS.  Coverage = mean
    CDS∩backbone fraction; identity = mean pairwise identity over the
    extracted columns."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    genome = ivs.genomes[annotated_seq]
    n = ivs.n_seqs
    nway_rows = [r for r in rows if (r[::2] != 0).all()]
    # hoist per-interval reference bounds and per-genome sorted CDS lists
    # out of the gene loop (these were recomputed per CDS)
    iv_bounds = []
    for k, iv in enumerate(ivs.intervals):
        if iv.starts[annotated_seq] == 0:
            iv_bounds.append(None)
        else:
            iv_bounds.append(
                (int(iv.lefts()[annotated_seq]), int(iv.rights()[annotated_seq]))
            )
    cds_by_genome = [
        sorted((f for f in g.features if f.kind == "CDS"), key=lambda f: f.start)
        for g in ivs.genomes
    ]
    out: List[dict] = []
    ortho_id = 0
    for feat in genome.features:
        if feat.kind != "CDS":
            continue
        lend, rend = int(feat.start), int(feat.end)
        nway_bb = [
            r for r in nway_rows
            if _overlap(lend, rend,
                        abs(int(r[2 * annotated_seq])),
                        abs(int(r[2 * annotated_seq + 1]))) > 0
        ]
        if not nway_bb:
            continue
        # interval with the largest CDS∩nway-backbone overlap (:178-212)
        overlaps = []
        for k, iv in enumerate(ivs.intervals):
            if iv_bounds[k] is None:
                continue
            il, ir = iv_bounds[k]
            inter = sum(
                _overlap(max(il, lend), min(ir, rend),
                         abs(int(r[2 * annotated_seq])),
                         abs(int(r[2 * annotated_seq + 1])))
                for r in nway_bb
            ) if _overlap(il, ir, lend, rend) else 0
            if inter > 0:
                overlaps.append((inter, k))
        if not overlaps:
            continue
        overlaps.sort()
        k = overlaps[-1][1]
        partial_rr = len(overlaps) > 1
        iv = ivs.intervals[k]
        pos = np.abs(_interval_positions(iv, annotated_seq))
        sel = np.nonzero((pos >= lend) & (pos <= rend))[0]
        if not len(sel):
            continue
        sub = iv.column_slice(int(sel[0]), int(sel[-1]) + 1)
        # per-genome best-overlap CDS within the extracted region (:239-276)
        ortho_cds = {}
        for s in range(n):
            if sub.starts[s] == 0:
                continue
            sl, sr = int(sub.lefts()[s]), int(sub.rights()[s])
            best = None
            for f2 in cds_by_genome[s]:
                if int(f2.start) > sr:
                    break  # sorted by start: nothing further overlaps
                l2 = _overlap(sl, sr, int(f2.start), int(f2.end))
                if l2 <= 0:
                    continue
                max_bb = max(
                    (_overlap(max(sl, int(f2.start)), min(sr, int(f2.end)),
                              abs(int(r[2 * s])), abs(int(r[2 * s + 1])))
                     for r in nway_bb),
                    default=0,
                )
                if best is None or max_bb > best[0]:
                    best = (max_bb, f2)
            if best is not None:
                ortho_cds[s] = best[1]
        entry = {
            "id": ortho_id,
            "name": feat.name,
            "start": lend,
            "end": rend,
            "rearranged": partial_rr,
            "orthologs": {
                s: (int(f2.start), int(f2.end), f2.name)
                for s, f2 in ortho_cds.items()
            },
            "complete": len(ortho_cds) == n,
        }
        if len(ortho_cds) != n:
            out.append(entry)  # tracked but not numbered (reference skips)
            continue
        # coverage: mean CDS∩nway-backbone fraction over genomes (:49-71)
        covs = []
        for s, f2 in ortho_cds.items():
            intlen = sum(
                _overlap(int(f2.start), int(f2.end),
                         abs(int(r[2 * s])), abs(int(r[2 * s + 1])))
                for r in nway_bb
            )
            covs.append(intlen / max(int(f2.end) - int(f2.start) + 1, 1))
        entry["coverage"] = float(np.mean(covs))
        # identity: mean pairwise identity over the extracted columns
        texts = {
            s: np.frombuffer(
                sub.aligned_text(ivs.genomes, s).upper().encode(), np.uint8
            )
            for s in range(n)
            if sub.starts[s] != 0
        }
        ids = []
        keys = sorted(texts)
        for ai in range(len(keys)):
            for bi in range(ai + 1, len(keys)):
                ti, tj = texts[keys[ai]], texts[keys[bi]]
                both = (ti != ord("-")) & (tj != ord("-"))
                ids.append(
                    float((both & (ti == tj)).sum() / both.sum()) if both.any() else 0.0
                )
        entry["identity"] = float(np.mean(ids)) if ids else 0.0
        if output_base:
            from mauvealigner_tpu_torch.tools.common import write_fasta_row

            with open(f"{output_base}_{ortho_id}.fas", "w") as fh:
                for s in range(n):
                    write_fasta_row(fh, f"seq{s}", sub.aligned_text(ivs.genomes, s))
        ortho_id += 1
        out.append(entry)
    return out


# -- randomGeneSample (src/randomGeneSample.cpp:36) -------------------------

def random_gene_sample(
    ortho_list: List[dict], count: int, seed: int = 37
) -> List[dict]:
    rng = np.random.default_rng(seed)
    if count >= len(ortho_list):
        return list(ortho_list)
    idx = sorted(rng.choice(len(ortho_list), size=count, replace=False))
    return [ortho_list[i] for i in idx]


def random_gene_alignments(
    ivs: IntervalList,
    rows: Sequence[np.ndarray],
    annotated_seq: int,
    count: int,
    output_base: str,
    seed: int = 37,
) -> List[dict]:
    """Reference randomGeneSample (src/randomGeneSample.cpp:83-160): sample
    `count` CDS genes (without replacement) fully contained in an N-way
    backbone segment, extract each gene's column range from the interval
    that strictly contains it, and write `<base>_<i>.fas` per gene."""
    from mauvealigner_tpu_torch.analysis.score_alignment import _interval_positions

    genome = ivs.genomes[annotated_seq]
    nway_rows = [r for r in rows if (r[::2] != 0).all()]
    eligible = []
    for feat in genome.features:
        if feat.kind != "CDS":
            continue
        lend, rend = int(feat.start), int(feat.end)
        contained = any(
            abs(int(r[2 * annotated_seq])) <= lend
            and rend <= abs(int(r[2 * annotated_seq + 1]))
            for r in nway_rows
        )
        if contained:
            eligible.append(feat)
    rng = np.random.default_rng(seed)
    if count < len(eligible):
        idx = rng.choice(len(eligible), size=count, replace=False)
        sample = [eligible[int(i)] for i in idx]
    else:
        sample = eligible
    out = []
    for i, feat in enumerate(sample):
        lend, rend = int(feat.start), int(feat.end)
        for iv in ivs.intervals:
            if iv.starts[annotated_seq] == 0:
                continue
            il = int(iv.lefts()[annotated_seq])
            ir = int(iv.rights()[annotated_seq])
            if il < lend and rend < ir:
                pos = np.abs(_interval_positions(iv, annotated_seq))
                sel = np.nonzero((pos >= lend) & (pos <= rend))[0]
                if not len(sel):
                    break
                sub = iv.column_slice(int(sel[0]), int(sel[-1]) + 1)
                from mauvealigner_tpu_torch.tools.common import write_fasta_row

                with open(f"{output_base}_{i}.fas", "w") as fh:
                    for s in range(ivs.n_seqs):
                        write_fasta_row(fh, f"seq{s}",
                                        sub.aligned_text(ivs.genomes, s))
                out.append({"name": feat.name, "start": lend, "end": rend,
                            "file": f"{output_base}_{i}.fas"})
                break
    return out


# -- pairCompare (src/pairCompare.cpp:19-60) --------------------------------

def pair_compare(
    ivs: IntervalList, genomes: Sequence[Genome], rows: Sequence[np.ndarray] = ()
) -> dict:
    """NT identity (over simpleFindBackbone(50, 50) regions, the
    BackboneIdentityMatrix computation), average backbone fraction, and
    LCB count for a pairwise alignment (src/pairCompare.cpp:36-78)."""
    from mauvealigner_tpu_torch.analysis.distance import backbone_identity_matrix
    from mauvealigner_tpu_torch.analysis.islands import simple_find_backbone

    n_lcbs = sum(1 for iv in ivs.intervals if iv.multiplicity() >= 2)
    segs = simple_find_backbone(ivs, 50, 50)
    if ivs.n_seqs >= 2 and segs:
        ident = float(backbone_identity_matrix(ivs, genomes, segs)[0, 1])
    else:
        ident = 0.0
    if rows:
        bb_frac = float(backbone_coverage(rows, [len(g) for g in genomes]).mean())
    else:
        # avg backbone length / avg sequence length (:62-70)
        total_bb = np.zeros(ivs.n_seqs, np.int64)
        for seg in segs:
            lens = np.abs(seg.rights) - np.abs(seg.lefts) + 1
            total_bb += np.where(seg.lefts != 0, lens, 0)
        seq_lens = np.array([len(g) for g in genomes], np.float64)
        bb_frac = (
            float(total_bb.mean() / seq_lens.mean()) if seq_lens.mean() else 0.0
        )
    return {
        "identity": ident,
        "lcb_count": n_lcbs,
        "backbone_fraction": bb_frac,
    }
