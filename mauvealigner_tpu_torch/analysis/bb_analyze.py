"""Comparative-genomics backbone analysis.

Equivalents of bbAnalyze (src/bbAnalyze.cpp: feature intersection with
annotations :232-282, variable-segment/"alternalog" detection :426-521,
intergenic classification :355) and bbBreakOnGenes (src/bbBreakOnGenes.cpp:
split backbone segments on annotated gene boundaries).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Genome


@dataclasses.dataclass
class SegmentReport:
    row_index: int
    n_genomes: int
    is_core: bool          # present in every genome
    is_variable: bool      # present in a strict subset (candidate alternalog)
    length: int            # in the annotated reference (or max member length)
    features: List[str]    # overlapping CDS/gene names in the reference
    intergenic: bool
    # alternalog classification vs the reference annotations
    # (src/bbAnalyze.cpp:816-931)
    genic: bool = False         # entirely inside one CDS
    spanner: bool = False       # overlaps a CDS boundary
    contains_trna: bool = False
    contains_rrna: bool = False
    contains_miscrna: bool = False
    # intergenic-neighbor classification (:869-873): orientation of the
    # flanking CDS pair, or an RNA nearest neighbor
    neighbor: str = ""          # converging | diverging | inline | tRNA | miscRNA


def classify_segments(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    reference: Optional[Genome] = None,
    ref_index: int = 0,
) -> List[SegmentReport]:
    all_feats = sorted(
        (reference.features if reference else []), key=lambda f: f.start
    )
    feats = [f for f in all_feats if f.kind in ("CDS", "gene")]
    cds = [f for f in all_feats if f.kind == "CDS"]
    rnas = {
        kind: [f for f in all_feats if f.kind == kind]
        for kind in ("tRNA", "rRNA", "misc_RNA")
    }
    feat_starts = np.array([f.start for f in feats], np.int64)
    reports = []
    for i, r in enumerate(rows):
        members = r[::2] != 0
        n = int(members.sum())
        lengths = np.abs(r[1::2]) - np.abs(r[::2]) + 1
        length = int(lengths[members].max()) if n else 0
        overlapping: List[str] = []
        rep = SegmentReport(
            row_index=i,
            n_genomes=n,
            is_core=n == n_seqs,
            is_variable=0 < n < n_seqs,
            length=length,
            features=overlapping,
            intergenic=True,
        )
        if reference is not None and members[ref_index]:
            l, rr = abs(int(r[2 * ref_index])), abs(int(r[2 * ref_index + 1]))
            hi = int(np.searchsorted(feat_starts, rr, side="right"))
            for f in feats[:hi]:
                if f.end >= l:
                    overlapping.append(f.name)
                    rep.intergenic = False
                    if f.kind == "CDS":
                        if f.start <= l and rr <= f.end:
                            rep.genic = True
                        else:
                            rep.spanner = True
            # containment, like the adjacent genic test: the RNA feature
            # must lie entirely inside the segment
            rep.contains_trna = any(
                l <= f.start and f.end <= rr for f in rnas["tRNA"]
            )
            rep.contains_rrna = any(
                l <= f.start and f.end <= rr for f in rnas["rRNA"]
            )
            rep.contains_miscrna = any(
                l <= f.start and f.end <= rr for f in rnas["misc_RNA"]
            )
            if rep.intergenic:
                # nearest annotated neighbors on each side (:858-873)
                left_cds = max((f for f in cds if f.end < l),
                               key=lambda f: f.end, default=None)
                right_cds = min((f for f in cds if f.start > rr),
                                key=lambda f: f.start, default=None)
                near_rna = ""
                for kind, label in (("tRNA", "tRNA"), ("misc_RNA", "miscRNA")):
                    for f in rnas[kind]:
                        lo = left_cds.end if left_cds else 0
                        hi2 = right_cds.start if right_cds else (rr + length + 1)
                        if lo <= f.start and f.end <= hi2:
                            near_rna = label
                            break
                    if near_rna:
                        break
                if near_rna:
                    rep.neighbor = near_rna
                elif left_cds is not None and right_cds is not None:
                    if left_cds.strand > 0 and right_cds.strand < 0:
                        rep.neighbor = "converging"
                    elif left_cds.strand < 0 and right_cds.strand > 0:
                        rep.neighbor = "diverging"
                    else:
                        rep.neighbor = "inline"
        reports.append(rep)
    return reports


def category_enrichment(
    reports: Sequence[SegmentReport],
    categories: Dict[str, str],
) -> List[Tuple[str, int, int, float]]:
    """Chi-square enrichment of functional categories among variable segments
    (MultiFun chi-square analog, src/bbAnalyze.cpp:232-282).

    categories: feature name -> category label.  Returns per category
    (label, n_in_variable, n_in_core, chi2_statistic).
    """
    var_counts: Counter = Counter()
    core_counts: Counter = Counter()
    for rep in reports:
        target = var_counts if rep.is_variable else core_counts
        for name in rep.features:
            cat = categories.get(name)
            if cat:
                target[cat] += 1
    total_var = sum(var_counts.values())
    total_core = sum(core_counts.values())
    out = []
    for cat in sorted(set(var_counts) | set(core_counts)):
        a = var_counts.get(cat, 0)
        b = core_counts.get(cat, 0)
        if total_var + total_core == 0:
            continue
        exp_a = (a + b) * total_var / max(total_var + total_core, 1)
        exp_b = (a + b) * total_core / max(total_var + total_core, 1)
        chi2 = 0.0
        if exp_a > 0:
            chi2 += (a - exp_a) ** 2 / exp_a
        if exp_b > 0:
            chi2 += (b - exp_b) ** 2 / exp_b
        out.append((cat, a, b, chi2))
    out.sort(key=lambda t: -t[3])
    return out


def bb_analyze_report(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    reference: Optional[Genome] = None,
    categories: Optional[Dict[str, str]] = None,
    out: Optional[TextIO] = None,
    genomes: Optional[Sequence[Genome]] = None,
    anno_index: int = 0,
) -> List[SegmentReport]:
    reports = classify_segments(rows, n_seqs, reference, ref_index=anno_index)
    if out is not None:
        n_core = sum(1 for r in reports if r.is_core)
        n_var = sum(1 for r in reports if r.is_variable)
        var = [r for r in reports if r.is_variable]
        out.write(f"segments: {len(reports)}\n")
        out.write(f"core segments: {n_core}\n")
        out.write(f"variable segments: {n_var}\n")
        sites, alts = variable_and_alternalog_sites(rows, n_seqs)
        out.write(f"There are {len(sites)} variable segment sites\n")
        out.write(f"There are {len(alts)} alternalog sites\n")
        out.write(
            f"intergenic variable segments: "
            f"{sum(1 for r in var if r.intergenic)}\n"
        )
        if reference is not None:
            # reference-style alternalog breakdown (src/bbAnalyze.cpp:816-931)
            def count(pred):
                return sum(1 for r in var if pred(r))

            out.write(f"variable sites within CDS: {count(lambda r: r.genic)}\n")
            out.write(
                f"variable sites spanning CDS boundaries: "
                f"{count(lambda r: r.spanner)}\n"
            )
            out.write(
                f"variable sites containing rRNA: "
                f"{count(lambda r: r.contains_rrna)}\n"
            )
            out.write(
                f"variable sites containing tRNA: "
                f"{count(lambda r: r.contains_trna)}\n"
            )
            out.write(
                f"variable sites containing misc_RNA: "
                f"{count(lambda r: r.contains_miscrna)}\n"
            )
            for label, text in (
                ("tRNA", "intergenic segments with a tRNA nearest neighbor"),
                ("miscRNA", "intergenic segments with a miscRNA nearest neighbor"),
                ("converging", "intergenic segments surrounded by converging CDS"),
                ("diverging", "intergenic segments surrounded by diverging CDS"),
                ("inline", "intergenic segments surrounded by inline CDS"),
            ):
                out.write(
                    f"There are {count(lambda r: r.neighbor == label)} {text}\n"
                )
        if categories:
            out.write("NumGenes\tGenesInCat\tPercent\tChi_square\tCategory\n")
            enrich = category_enrichment(reports, categories)
            total = sum(a + b for _, a, b, _ in enrich) or 1
            for cat, a, b, chi2 in enrich:
                out.write(
                    f"{a + b}\t{a}\t{(a + b) / total:.4f}\t{chi2:.3f}\t{cat}\n"
                )
        # full per-region analysis of the variable sites, then the strict
        # >= 2-allele "alternalogs" (reference main :1404-1408)
        seq_list = genomes
        if seq_list is None and reference is not None:
            seq_list = [
                reference if s == anno_index else None for s in range(n_seqs)
            ]
        analyze_variable_segments(
            rows, n_seqs, seq_list, anno_index, alternalogs=False, out=out,
            site_name="variable segments", precomputed=(sites, alts),
        )
        analyze_variable_segments(
            rows, n_seqs, seq_list, anno_index, alternalogs=True, out=out,
            site_name="alternalogs", precomputed=(sites, alts),
        )
    return reports


def _print_filtered_rows(
    out: TextIO, region_rows: Sequence[np.ndarray], mask: Sequence[bool]
) -> None:
    """printFilteredBbSeqList (src/bbAnalyze.cpp:343-353): tab-separated
    signed coordinate pairs of every selected region."""
    for r, m in zip(region_rows, mask):
        if m:
            out.write("\t".join(str(int(x)) for x in r) + "\n")


def _features_hit(
    region_rows: Sequence[np.ndarray],
    mask: np.ndarray,
    features,
    s: int,
) -> np.ndarray:
    """Boolean per-feature: overlapped by any selected region in genome s
    (featureIntersect + getFeatureHits, src/bbAnalyze.cpp:180-230)."""
    hit = np.zeros(len(features), bool)
    spans = sorted(
        (abs(int(r[2 * s])), abs(int(r[2 * s + 1])))
        for r, m in zip(region_rows, mask)
        if m and r[2 * s] != 0
    )
    if not spans:
        return hit
    starts = np.array([a for a, _ in spans], np.int64)
    ends_max = np.maximum.accumulate(np.array([b for _, b in spans], np.int64))
    for fi, f in enumerate(features):
        i = int(np.searchsorted(starts, f.end, side="right"))
        hit[fi] = i > 0 and ends_max[i - 1] >= f.start
    return hit


def write_gene_content_distribution(
    out: TextIO,
    region_rows: Sequence[np.ndarray],
    mask: np.ndarray,
    reference: Genome,
    ref_index: int,
    categories: Dict[str, str],
    label: str,
) -> None:
    """One mfAnalyze section (src/bbAnalyze.cpp:232-282): percentage of CDS
    hit by the selected segment class plus the per-category enrichment
    table (chi-square vs the expected hit frequency; rows below the
    significance/expectation thresholds are dropped, reference :257-259).
    Output format mirrors the reference's LaTeX-style table rows."""
    cds = [f for f in reference.features if f.kind == "CDS"]
    if not cds:
        return
    hits = _features_hit(region_rows, mask, cds, ref_index)
    expect_freq = float(hits.sum()) / len(cds)
    out.write(f"#\n#{label} gene content distribution\n#\n")
    out.write(f"Avg percent {label.lower()} {expect_freq * 100:.3g}\n")
    all_count: Counter = Counter()
    sub_count: Counter = Counter()
    for f, h in zip(cds, hits):
        cat = categories.get(f.name)
        if not cat:
            continue
        all_count[cat] += 1
        if h:
            sub_count[cat] += 1
    rows_out = []
    # iterate every annotated category: a zero-hit category can still be
    # significantly UNDER-represented (chi2 = expected at n_sub = 0)
    for cat, n_all in all_count.items():
        n_sub = sub_count.get(cat, 0)
        expected = n_all * expect_freq
        if expected <= 0:
            continue
        chi2 = (n_sub - expected) ** 2 / expected
        if chi2 < CHI_SQUARE_THRESHOLD or expected < MIN_EXPECTED_THRESHOLD:
            continue
        rows_out.append((n_sub, n_all, n_sub / n_all * 100, chi2, cat))
    rows_out.sort(key=lambda t: t[2])
    delim, new_row = " & ", "\\\\\n\\hline\n"
    out.write(
        f"NumGenes{delim}GenesInCat{delim}Percent{delim}"
        f"Chi_square{delim}Mf_Level_2_name{new_row}"
    )
    for i, (n_sub, n_all, pct, chi2, cat) in enumerate(rows_out):
        if i > 0 and rows_out[i - 1][2] < expect_freq * 100 < pct:
            out.write(new_row)  # under- to over-represented transition
        out.write(
            f"{n_sub}{delim}{n_all}{delim}{pct:.3g}{delim}{chi2:.3g}{delim}"
            f"{cat}{new_row}"
        )


def analyze_variable_segments(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    genomes: Optional[Sequence[Genome]] = None,
    anno_index: int = 0,
    alternalogs: bool = False,
    out: Optional[TextIO] = None,
    site_name: str = "variable segments",
    precomputed=None,
) -> Tuple[List[np.ndarray], List[List[SegmentReport]]]:
    """analyzeVariableSegments (src/bbAnalyze.cpp:808-941): the variable
    REGIONS between consecutive n-way flanks are classified against every
    genome's own annotations; the reference's report lines are emitted to
    `out`.  Returns (region coordinate rows, per-genome region reports).
    ``precomputed`` takes an existing ``variable_and_alternalog_sites``
    result so one detection pass serves the whole report.
    """
    sites, alts = (
        precomputed
        if precomputed is not None
        else variable_and_alternalog_sites(rows, n_seqs)
    )
    chosen = alts if alternalogs else sites
    region_rows = [region for _, _, region in chosen]
    A = len(region_rows)
    per_genome: List[List[SegmentReport]] = []
    for s in range(n_seqs):
        g = None
        if genomes and s < len(genomes) and getattr(genomes[s], "features", None):
            g = genomes[s]
        per_genome.append(classify_segments(region_rows, n_seqs, g, ref_index=s))
    if out is None:
        return region_rows, per_genome

    out.write(f"There are {A} {site_name} sites\n")
    present = np.zeros((A, n_seqs), bool)
    for a, r in enumerate(region_rows):
        present[a] = r[::2] != 0
    genic = np.zeros((n_seqs, A), bool)
    inter = np.zeros((n_seqs, A), bool)
    spanner = np.zeros((n_seqs, A), bool)
    for s in range(n_seqs):
        for a, rep in enumerate(per_genome[s]):
            genic[s, a] = rep.genic
            inter[s, a] = present[a, s] and rep.intergenic
            spanner[s, a] = rep.spanner
    multi_genes = genic.all(axis=0) if A else np.zeros(0, bool)
    multi_inter = inter.all(axis=0) if A else np.zeros(0, bool)
    multi_entirely = (inter & ~spanner).all(axis=0) if A else np.zeros(0, bool)
    out.write(
        f" There are {int(multi_genes.sum())} apparently multi-allelic genes "
        f"({site_name})\n"
    )
    out.write(
        f" There are {int(multi_inter.sum())} apparently multi-allelic "
        f"regions with intergenic endpoints ({site_name})\n"
    )
    out.write(
        f" Of those, {int(multi_entirely.sum())} contain no annotated CDS "
        f"({site_name})\n"
    )
    out.write(
        " The remaining segments span gene boundaries, but are not entirely "
        "contained in annotated genes\n"
    )
    anno_reps = per_genome[anno_index]
    # classifyIntergenic on the multi-allelic intergenic set (:865-873)
    def neigh(label):
        return np.array(
            [m and anno_reps[a].neighbor == label for a, m in enumerate(multi_inter)],
            bool,
        )

    trna_n, misc_n = neigh("tRNA"), neigh("miscRNA")
    conv, div, inl = neigh("converging"), neigh("diverging"), neigh("inline")
    out.write(f"There are {int(trna_n.sum())} intergenic segments with a tRNA nearest neighbor\n")
    out.write(f"There are {int(misc_n.sum())} intergenic segments with a miscRNA nearest neighbor\n")
    out.write(f"There are {int(conv.sum())} intergenic segments surrounded by converging CDS\n")
    out.write(f"There are {int(div.sum())} intergenic segments surrounded by diverging CDS\n")
    out.write(f"There are {int(inl.sum())} intergenic segments surrounded by inline CDS\n")

    anno = genomes[anno_index] if genomes and anno_index < len(genomes) else None
    feats = list(getattr(anno, "features", []) or [])
    all_mask = np.ones(A, bool)
    misc_feats = [f for f in feats if f.kind == "misc_RNA"]
    trna_feats = [f for f in feats if f.kind == "tRNA"]
    misc_assoc = _features_hit(region_rows, all_mask, misc_feats, anno_index)
    trna_assoc = _features_hit(region_rows, all_mask, trna_feats, anno_index)
    out.write(
        f"There are {int(misc_assoc.sum())} annotated misc_RNA associated "
        f"with variable segments\n"
    )
    # intergenic ranges of the annotated genome and their variability
    # (identifyIntergenicRanges, :532-572)
    cds = sorted((f for f in feats if f.kind == "CDS"), key=lambda f: f.start)
    ranges = [
        (cds[i].end, cds[i + 1].start)
        for i in range(len(cds) - 1)
        if cds[i].end < cds[i + 1].start
    ]
    n_var_ranges = 0
    if ranges and A:
        lo = np.array([abs(int(r[2 * anno_index])) for r in region_rows])
        hi = np.array([abs(int(r[2 * anno_index + 1])) for r in region_rows])
        pres = lo != 0
        for ra, rb in ranges:
            if (pres & (lo <= rb - 1) & (hi >= ra + 1)).any():
                n_var_ranges += 1
    out.write(
        f"There are {len(ranges)} intergenic sites in the ref genome, of "
        f"which {n_var_ranges} exhibit variability\n"
    )
    out.write(
        f"There are {int(trna_assoc.sum())} annotated tRNA associated with "
        f"variable segments\n"
    )
    if misc_n.any():
        out.write("coordinates of variable segs with misc_RNA neighboring:\n")
        _print_filtered_rows(out, region_rows, misc_n)
    if div.any():
        out.write("coordinates of variable segs with diverging_cds neighboring:\n")
        _print_filtered_rows(out, region_rows, div)
    contains_misc = np.array([r.contains_miscrna for r in anno_reps], bool)
    out.write(
        f"Total variable intergenic segs that neighbor or contain miscRNA: "
        f"{int((contains_misc | misc_n).sum())}\n"
    )
    out.write("coordinates of multi-allelic genes:\n")
    _print_filtered_rows(out, region_rows, multi_genes)
    out.write("coordinates of multi-allelic intergenic regions without CDS:\n")
    _print_filtered_rows(out, region_rows, multi_entirely)

    for s in range(n_seqs):
        reps = per_genome[s]
        g_mask = np.array([r.genic for r in reps], bool)
        sp_mask = np.array([r.spanner for r in reps], bool)
        in_mask = inter[s]
        rr_mask = np.array([r.contains_rrna for r in reps], bool)
        tr_mask = np.array([r.contains_trna for r in reps], bool)
        mi_mask = np.array([r.contains_miscrna for r in reps], bool)
        # pseudogenized: present but not genic here, genic somewhere else
        # (:826-829)
        other_genic = (
            genic[np.arange(n_seqs) != s].any(axis=0) if A else np.zeros(0, bool)
        )
        ps_mask = present[:, s] & ~genic[s] & other_genic
        out.write(f"genome {s} has {int(g_mask.sum())} {site_name} within CDS\n")
        out.write(
            f"genome {s} has {int(sp_mask.sum())} {site_name} that span CDS "
            f"boundaries\n"
        )
        out.write(
            f"genome {s} has {int(in_mask.sum())} {site_name} that lie "
            f"entirely in intergenic regions\n"
        )
        out.write(f"genome {s} has {int(rr_mask.sum())} {site_name} that contain rRNA\n")
        out.write(f"genome {s} has {int(tr_mask.sum())} {site_name} that contain tRNA\n")
        out.write(f"genome {s} has {int(mi_mask.sum())} {site_name} that contain misc_RNA\n")
        out.write(
            f"genome {s} has {int(ps_mask.sum())} apparent recent pseudogenes "
            f"in {site_name}\n"
        )
        if tr_mask.any():
            out.write(f"coordinates of tRNA {site_name}:\n")
            _print_filtered_rows(out, region_rows, tr_mask)
        if rr_mask.any():
            out.write(f"coordinates of rRNA {site_name}:\n")
            _print_filtered_rows(out, region_rows, rr_mask)
        if mi_mask.any():
            out.write(f"coordinates of misc_RNA {site_name}:\n")
            _print_filtered_rows(out, region_rows, mi_mask)
        out.write("coordinates of possible pseudogenes:\n")
        _print_filtered_rows(out, region_rows, ps_mask)
    return region_rows, per_genome


def ptt_gene_bounds(path: str) -> np.ndarray:
    """Gene boundaries from an NCBI .ptt table (src/bbBreakOnGenes.cpp:261-285):
    three header lines are skipped; each row's leading ``lend..rend`` yields
    breakpoints {lend-1, lend, rend, rend+1} (the ptt path breaks on *both*
    sides of each gene edge)."""
    bounds: List[int] = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for line in lines[3:]:
        head = line.split("\t", 1)[0]
        if ".." not in head:
            continue
        a, _, b = head.partition("..")
        try:
            lend, rend = int(a.strip()), int(b.strip().split()[0])
        except ValueError:
            continue
        bounds.extend((lend - 1, lend, rend, rend + 1))
    return np.array(sorted(bounds), np.int64)


def genbank_gene_bounds(genome: Genome) -> np.ndarray:
    """CDS boundaries {first, last+1} from annotations
    (src/bbBreakOnGenes.cpp:289-307; only CDS features count, and
    malformed locations — first > last or a zero — are skipped)."""
    bounds: List[int] = []
    for f in genome.features:
        if f.kind != "CDS":
            continue
        if f.start > f.end or f.start == 0 or f.end == 0:
            continue
        bounds.extend((f.start, f.end + 1))
    return np.array(sorted(bounds), np.int64)


def break_on_genes(
    ivs, min_bb_gap: int, gene_bounds: Sequence[np.ndarray]
) -> List[np.ndarray]:
    """bbBreakOnGenes pipeline (src/bbBreakOnGenes.cpp:203-353): re-detect
    backbone from the alignment with a BigGapsDetector(min_bb_gap) over all
    pairwise projections, splitting segments at every genome's gene-boundary
    columns, then emit per-segment signed coordinate rows.  The reference
    leaves mergeAdjacentSegments/addUniqueSegments commented out (:341-342)
    so gene splits survive to the output."""
    from mauvealigner_tpu_torch.analysis.backbone import (
        backbone_seq_coordinates,
        detect_backbone_big_gaps,
    )

    segments = detect_backbone_big_gaps(ivs, min_bb_gap, gene_bounds)
    return backbone_seq_coordinates(ivs, segments)


def gene_boundary_violations(
    rows: Sequence[np.ndarray], gene_bounds: Sequence[np.ndarray]
) -> List[str]:
    """Post-write audit (src/bbBreakOnGenes.cpp:313-338): report every
    backbone segment that strictly straddles a gene boundary (more than
    1 bp on each side).  The reference's deliberately-bogus self-test
    bounds (:315-318) are not inserted."""
    msgs: List[str] = []
    if not rows:
        return msgs
    n_seqs = len(rows[0]) // 2
    for s in range(n_seqs):
        bounds = np.sort(np.asarray(gene_bounds[s], np.int64)) if len(gene_bounds) > s and gene_bounds[s] is not None else np.zeros(0, np.int64)
        srows = sorted(rows, key=lambda r: abs(int(r[2 * s])))
        bI = 0
        for g in bounds:
            while bI < len(srows) and g > abs(int(srows[bI][2 * s + 1])):
                bI += 1
            if bI == len(srows):
                break
            first = abs(int(srows[bI][2 * s]))
            second = abs(int(srows[bI][2 * s + 1]))
            if first + 1 < g < second - 1:
                msgs.append(
                    f"segment {srows[bI][2 * s]}, {srows[bI][2 * s + 1]} "
                    f"violates gene boundary {g} in seq {s}"
                )
    return msgs


# ---------------------------------------------------------------------------
# Per-tree-node backbone analysis: the deep half of the reference report
# (src/bbAnalyze.cpp:1040-1411) — faux single-genome segments for unaligned
# regions, per-node unique/conserved/hop classification with segment-level
# bitsets, core/pan-genome length accounting, and per-class functional
# enrichment against the annotated genome.
# ---------------------------------------------------------------------------

DISCARD_SEGMENT = 20      # src/bbAnalyze.cpp:21
CHI_SQUARE_THRESHOLD = 5  # :230
MIN_EXPECTED_THRESHOLD = 5  # :231


@dataclasses.dataclass
class NodeSummary:
    node_id: int
    leaf_seqs: List[int]
    n_unique: int      # segments present in exactly the leaves below
    n_hop_one: int     # single-deletion pattern (src/bbAnalyze.cpp:1154-1156)
    n_hop_two: int     # multiple deletion or LGT pattern
    core_len: float    # total avg length of segments conserved below
    unique_len: float
    hop_one_len: float
    hop_two_len: float
    pan_genome_len: float
    # per-class segment masks over the (faux-extended) row list — feed the
    # per-node gene-content distributions (src/bbAnalyze.cpp:1368-1400)
    conserved_mask: Optional[np.ndarray] = None
    unique_mask: Optional[np.ndarray] = None
    hop_one_mask: Optional[np.ndarray] = None
    hop_two_mask: Optional[np.ndarray] = None
    all_unique_mask: Optional[np.ndarray] = None  # unique below OR at node (:1254)
    rows_used: Optional[List[np.ndarray]] = None  # row list the masks index


def add_faux_unique_segments(
    rows: Sequence[np.ndarray], n_seqs: int, seq_lengths: Sequence[int]
) -> List[np.ndarray]:
    """Append single-genome segments covering every region of every genome
    not in real backbone (the reference's faux-segment construction via
    AddGapMatches, src/bbAnalyze.cpp:1035-1079)."""
    out = list(rows)
    for s in range(n_seqs):
        ivs = []
        for r in rows:
            l, rr = int(r[2 * s]), int(r[2 * s + 1])
            if l == 0 and rr == 0:
                continue
            a, b = sorted((abs(l), abs(rr)))
            ivs.append((a, b))
        ivs.sort()
        cur = 1
        gaps = []
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, a - 1))
            cur = max(cur, b + 1)
        if cur <= seq_lengths[s]:
            gaps.append((cur, seq_lengths[s]))
        for a, b in gaps:
            row = np.zeros(2 * n_seqs, np.int64)
            row[2 * s], row[2 * s + 1] = a, b
            out.append(row)
    return out


def tree_node_analysis(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    tree,
    seq_lengths: Optional[Sequence[int]] = None,
    min_segment: int = DISCARD_SEGMENT,
) -> List[NodeSummary]:
    """Classify every backbone segment at every guide-tree node.

    Definitions follow src/bbAnalyze.cpp:1140-1276: `unique` = present in
    exactly the leaves below the node; `conserved` = present in all leaves
    below; `hop_two` = partially present in BOTH children but complete in
    neither (multiple independent deletions or LGT); `hop_one` = one child
    incomplete, not already explained by a child's hop_one (a single
    deletion event on the incomplete side).  Segments shorter than
    `min_segment` are ignored; faux single-genome segments are added for
    unaligned regions when seq_lengths is given.
    """
    if seq_lengths is not None:
        rows = add_faux_unique_segments(rows, n_seqs, seq_lengths)
    S = len(rows)
    if S == 0:
        return []
    mat = np.stack(rows)  # [S, 2*n_seqs]
    present = mat[:, ::2] != 0
    span = np.abs(np.abs(mat[:, 1::2]) - np.abs(mat[:, ::2])) + 1
    span = np.where(present, span, 0)
    counts_all = present.sum(axis=1)
    avg_len = span.sum(axis=1) / np.maximum(counts_all, 1)
    not_small = span.max(axis=1) >= min_segment

    # post-order node list
    nodes: List = []

    def walk(n):
        for c in n.children:
            walk(c)
        nodes.append(n)

    walk(tree)
    node_ids = {id(n): i for i, n in enumerate(nodes)}
    summaries: List[NodeSummary] = []
    hop_one_bits: Dict[int, np.ndarray] = {}
    for ni, node in enumerate(nodes):
        leaf_idx = [int(l.name) for l in node.leaves()]
        mask = np.zeros(n_seqs, bool)
        mask[leaf_idx] = True
        ct = present[:, mask].sum(axis=1)
        ct_out = present[:, ~mask].sum(axis=1)
        conserved = ct == len(leaf_idx)
        unique = conserved & (ct_out == 0)
        if len(node.children) >= 2:
            # generalized beyond the reference's strictly-binary trees
            # (unrooted Newick routinely has a trifurcating root): a segment
            # is hop_two when >= 2 children hold it partially and NO child
            # holding it is complete (multiple independent deletions / LGT);
            # hop_one when some child is incomplete but the pattern is
            # explained by a single deletion not already counted below
            partials, completes = [], []
            for c in node.children:
                cm = np.zeros(n_seqs, bool)
                cm[[int(l.name) for l in c.leaves()]] = True
                c_ct = present[:, cm].sum(axis=1)
                partials.append(c_ct > 0)
                completes.append(c_ct == int(cm.sum()))
            partials = np.stack(partials)   # [n_children, S]
            completes = np.stack(completes)
            n_partial = partials.sum(axis=0)
            any_incomplete = (partials & ~completes).any(axis=0)
            no_partial_complete = ~(partials & completes).any(axis=0)
            hop_two = (n_partial >= 2) & no_partial_complete
            child_hop = np.zeros(S, bool)
            for c in node.children:
                child_hop |= hop_one_bits.get(node_ids[id(c)], np.zeros(S, bool))
            hop_one = (~hop_two) & any_incomplete & (n_partial >= 2) & ~child_hop
        else:
            hop_one = np.zeros(S, bool)
            hop_two = np.zeros(S, bool)
        hop_one &= not_small
        hop_two &= not_small
        hop_one_bits[ni] = hop_one
        uq = unique & not_small
        cs = conserved & not_small
        # all_unique: unique at this node or below (src/bbAnalyze.cpp:1254)
        all_uq = uq.copy()
        for c in node.children:
            cm = summaries[node_ids[id(c)]].all_unique_mask
            if cm is not None:
                all_uq |= cm
        summaries.append(NodeSummary(
            node_id=ni,
            leaf_seqs=sorted(leaf_idx),
            n_unique=int(uq.sum()),
            n_hop_one=int(hop_one.sum()),
            n_hop_two=int(hop_two.sum()),
            core_len=float(avg_len[cs].sum()),
            unique_len=float(avg_len[uq].sum()),
            hop_one_len=float(avg_len[hop_one].sum()),
            hop_two_len=float(avg_len[hop_two].sum()),
            pan_genome_len=float(avg_len[ct > 0].sum()),
            conserved_mask=cs,
            unique_mask=uq,
            hop_one_mask=hop_one,
            hop_two_mask=hop_two,
            all_unique_mask=all_uq,
            rows_used=list(rows),
        ))
    return summaries


def write_tree_analysis(
    summaries: Sequence[NodeSummary],
    out: TextIO,
    genome_names: Optional[Sequence[str]] = None,
    reference: Optional[Genome] = None,
    ref_index: int = 0,
    categories: Optional[Dict[str, str]] = None,
) -> None:
    """The per-node section of the reference report
    (src/bbAnalyze.cpp:1342-1400).  With an annotated `reference` (and a
    feature-name -> category map), every node containing the annotated
    genome also gets the four gene-content distributions (conserved /
    hop one / hop two / unique-to-clade), reference :1368-1399."""
    out.write("#\n# Alignment tree summary\n#\n")
    for s in summaries:
        out.write(f"Node {s.node_id}\n")
        out.write("Genomes at or below this node:\n")
        for i in s.leaf_seqs:
            name = genome_names[i] if genome_names else f"seq{i + 1}"
            out.write(f"\t{name}\n")
        out.write(f"\tNumber of unique segments at this node: {s.n_unique}\n")
        out.write(
            "\tNumber of hop one (single deletion) segments at this node: "
            f"{s.n_hop_one}\n"
        )
        out.write(
            "\tNumber of hop two (multiple deletion or lgt) segments at "
            f"this node: {s.n_hop_two}\n"
        )
        out.write(f'total avg. "core-genome" size at this node: {s.core_len:.6g}\n')
        out.write(f"total avg. unique length at this node: {s.unique_len:.6g}\n")
        out.write(f"total avg. hop one length at this node: {s.hop_one_len:.6g}\n")
        out.write(f"total avg. hop two length at this node: {s.hop_two_len:.6g}\n")
        out.write(f'total "pan-genome" size at this node: {s.pan_genome_len:.6g}\n')
        if (
            reference is not None
            and categories
            and s.rows_used is not None
            and ref_index in s.leaf_seqs
        ):
            for label, mask in (
                ("Conserved", s.conserved_mask),
                ("Hop one", s.hop_one_mask),
                ("Hop two", s.hop_two_mask),
                ("Unique to this clade", s.all_unique_mask),
            ):
                write_gene_content_distribution(
                    out, s.rows_used, mask, reference, ref_index,
                    categories, label,
                )


# ---------------------------------------------------------------------------
# Variable-segment / alternalog site detection between flanking n-way
# backbone (findVariableSegmentsWithFlankingBB + analyzeVariableSegments,
# src/bbAnalyze.cpp:426-560).
# ---------------------------------------------------------------------------

ALTERNALOG_MIN_SIZE = 15  # src/bbAnalyze.cpp:22


def variable_and_alternalog_sites(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    min_bb_size: int = ALTERNALOG_MIN_SIZE,
    min_variable_size: int = ALTERNALOG_MIN_SIZE,
) -> Tuple[
    List[Tuple[int, int, np.ndarray]], List[Tuple[int, int, np.ndarray]]
]:
    """One-pass detection of variable-segment sites AND alternalog sites.

    Sites are places where substantial variable content sits between two
    consecutive full-multiplicity backbone segments.  The reference walks
    its backbone list in file order within each interval; here adjacency is
    defined coordinate-wise (equivalent for a well-formed backbone): flank
    pairs are consecutive n-way segments along every genome, and a subset
    segment lies between them when all its members fall inside the
    per-genome gaps.  A variable site needs >= 1 distinct allele (subset
    segments or substantial unaligned gaps); an alternalog site needs >= 2.

    Instead of rescanning every backbone row per flank pair (quadratic),
    subset rows are bucketed onto flank gaps with one searchsorted pass per
    genome (per-genome gaps of distinct flank pairs are disjoint in a
    well-formed backbone), then alleles are counted per pair in row order.

    Returns ``(sites, alternalog_sites)``; each element is a
    (flank_a_index, flank_b_index, variable_region int64[2*n_seqs]) triple
    whose region row holds the per-genome [gap_left, gap_right] coordinates
    between the flanks (0,0 where empty).  ``alternalog_sites`` is a subset
    of ``sites``.
    """
    if not len(rows):
        return [], []
    mat = np.stack(rows).astype(np.int64)
    lefts = np.abs(mat[:, ::2])
    rights = np.abs(mat[:, 1::2])
    lo = np.minimum(lefts, rights)
    hi = np.maximum(lefts, rights)
    present = mat[:, ::2] != 0
    spans = np.where(present, hi - lo + 1, 0)
    nway = present.all(axis=1) & (spans.mean(axis=1) >= min_bb_size)
    nidx = np.nonzero(nway)[0]
    if len(nidx) < 2:
        return [], []
    order = nidx[np.argsort(lo[nidx, 0], kind="stable")]
    pair_a, pair_b = order[:-1], order[1:]
    n_pairs = len(pair_a)
    # per-genome gap between the flanks (flanks are n-way: all present);
    # pairs with overlapping/unordered flanks in any genome are not sites
    gap_l = hi[pair_a] + 1  # (n_pairs, n_seqs)
    gap_r = lo[pair_b] - 1
    valid = ~(gap_r < gap_l - 1).any(axis=1)

    # candidate subset rows: non-n-way, some member, substantial mean span
    counts = present.sum(axis=1)
    mean_span = spans.sum(axis=1) / np.maximum(counts, 1)
    cand = np.nonzero(
        ~nway & (counts > 0) & (mean_span >= min_variable_size)
    )[0]

    # bucket each candidate onto flank pairs: in every member genome its
    # interval must sit inside that pair's gap.  Per genome the gaps of
    # distinct pairs are disjoint on a collinear backbone, so a single
    # searchsorted pick per genome is exact there (ties broken toward the
    # widest gap so empty gaps never shadow a real one).  Rearrangements
    # make gaps of distinct pairs overlap or nest in some genome; the
    # candidates whose pick lands in such a neighborhood fall back to an
    # exact all-valid-pairs containment scan — which, like the reference's
    # per-pair rescan, may count one row for SEVERAL pairs.
    assign = np.full((len(cand), n_seqs), -1, np.int64)
    picked_dirty = np.zeros(len(cand), bool)     # pick in an overlap zone
    contain_fail = np.zeros(len(cand), bool)     # member genome provably
    for g in range(n_seqs):                      # without a containing gap
        ordp = np.lexsort((gap_r[:, g], gap_l[:, g]))
        gl_s, gr_s = gap_l[ordp, g], gap_r[ordp, g]
        overlaps = np.zeros(n_pairs, bool)
        if n_pairs > 1:
            cr = np.maximum.accumulate(gr_s)
            overlaps[1:] = gl_s[1:] <= cr[:-1]
            overlaps[:-1] |= gr_s[:-1] >= gl_s[1:]
        pos = np.searchsorted(gl_s, lo[cand, g], side="right") - 1
        pc = np.clip(pos, 0, n_pairs - 1)
        p = ordp[pc]
        memb = present[cand, g]
        has_pick = pos >= 0
        contained = (
            has_pick & (lo[cand, g] >= gap_l[p, g]) & (hi[cand, g] <= gap_r[p, g])
        )
        assign[:, g] = np.where(memb & contained, p, -1)
        dirty_g = has_pick & overlaps[pc]
        picked_dirty |= memb & dirty_g
        # with disjoint gaps the pick is the ONLY possible container, so a
        # clean containment failure rules the candidate out entirely
        contain_fail |= memb & ~contained & ~dirty_g
    first_member = np.argmax(present[cand], axis=1)
    prow = assign[np.arange(len(cand)), first_member]
    member_ok = (assign == prow[:, None]) | ~present[cand]
    belongs = ~picked_dirty & ~contain_fail & (prow >= 0) & member_ok.all(axis=1)
    belongs &= valid[np.clip(prow, 0, max(n_pairs - 1, 0))]

    memberships = [
        (int(prow[ci]), int(cand[ci])) for ci in np.nonzero(belongs)[0]
    ]
    dirty_idx = np.nonzero(picked_dirty & ~contain_fail)[0]
    if len(dirty_idx):
        vp = np.nonzero(valid)[0]
        if len(vp):
            chunk = max(1, (1 << 22) // max(len(vp) * n_seqs, 1))
            for off in range(0, len(dirty_idx), chunk):
                ch = dirty_idx[off : off + chunk]
                c_lo = lo[cand[ch]][:, None, :]          # (c, 1, g)
                c_hi = hi[cand[ch]][:, None, :]
                c_pr = present[cand[ch]][:, None, :]
                inside = (c_lo >= gap_l[vp][None]) & (c_hi <= gap_r[vp][None])
                okcp = (inside | ~c_pr).all(axis=2)      # (c, pairs)
                for a, b in zip(*np.nonzero(okcp)):
                    memberships.append((int(vp[b]), int(cand[ch[a]])))
    memberships.sort()  # (pair, row index): row order kept within each pair
    rows_of: Dict[int, List[int]] = {}
    for p_i, r_i in memberships:
        rows_of.setdefault(p_i, []).append(r_i)

    sites: List[Tuple[int, int, np.ndarray]] = []
    alts: List[Tuple[int, int, np.ndarray]] = []
    for p in range(n_pairs):
        if not valid[p]:
            continue
        gl, gr = gap_l[p], gap_r[p]
        alleles = 0
        seen = np.zeros(n_seqs, bool)
        for r in rows_of.get(p, ()):
            m = present[r]
            if (~seen[m]).any():
                alleles += 1
            seen |= m
        # members with a substantial unaligned gap count as alleles too
        gap_allele = (~seen) & (gr - gl + 1 >= min_variable_size)
        alleles += int(gap_allele.sum())
        if alleles > 0:
            region = np.zeros(2 * n_seqs, np.int64)
            nonempty = gr >= gl
            region[::2] = np.where(nonempty, gl, 0)
            region[1::2] = np.where(nonempty, gr, 0)
            trip = (int(pair_a[p]), int(pair_b[p]), region)
            sites.append(trip)
            if alleles > 1:
                alts.append(trip)
    return sites, alts


def find_variable_segments_with_flanking_bb(
    rows: Sequence[np.ndarray],
    n_seqs: int,
    min_bb_size: int = ALTERNALOG_MIN_SIZE,
    min_variable_size: int = ALTERNALOG_MIN_SIZE,
    alternalogs: bool = False,
) -> List[Tuple[int, int, np.ndarray]]:
    """Single-threshold view of :func:`variable_and_alternalog_sites`
    (findVariableSegmentsWithFlankingBB, src/bbAnalyze.cpp:426-521): with
    ``alternalogs`` a site needs >= 2 distinct alleles, otherwise one."""
    sites, alts = variable_and_alternalog_sites(
        rows, n_seqs, min_bb_size, min_variable_size
    )
    return alts if alternalogs else sites
