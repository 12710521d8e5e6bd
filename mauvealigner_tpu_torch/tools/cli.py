"""CLI of the port: the reference tools as subcommands.

Usage:  python -m mauvealigner_tpu_torch.tools mauveAligner a.fa b.fa \\
            --output-alignment=o.xmfa [--device=cuda]
        python -m mauvealigner_tpu_torch.tools progressiveMauve a.fa b.fa c.fa \\
            --output=o.xmfa [--device=cuda]
        python -m mauvealigner_tpu_torch.tools repeatoire --sequence=g.fa \\
            --output=reps.xmfa [--xml=reps.xml] [--device=cuda]
        python -m mauvealigner_tpu_torch.tools --list

Port of mauvealigner_tpu/tools/cli.py: the three aligners with every flag
of the reference's command lines (src/mauveAligner.cpp,
src/progressiveMauve.cpp, src/repeatoire.cpp), the scoring tools
(scoreAlignment, scoreProcrastAlignment, scoreALU), evd and multiEVD,
bbAnalyze and bbBreakOnGenes, gappiness, and the format converters.  The
aligners take --device (cuda runs the CUDA kernels, cpu the plain-torch
versions); the other tools are host code.  What is not ported yet is listed
in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List

import numpy as np

from mauvealigner_tpu_torch.core.interval import IntervalList
from mauvealigner_tpu_torch.tools.common import (
    load_genome,
    load_genomes,
    open_out,
    write_fasta_row,
)

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn

    return deco


def _read_alignment(path: str, seq_files: List[str]) -> IntervalList:
    genomes = load_genomes(seq_files) if seq_files else None
    ivl = IntervalList.read_xmfa(path, genomes=genomes)
    if genomes is None and any(ivl.seq_filenames):
        try:
            ivl.genomes = load_genomes(ivl.seq_filenames)
        except OSError:
            pass
    return ivl


def _no_mesh(mesh_devices: int) -> None:
    if mesh_devices > 1:
        raise NotImplementedError(
            "--mesh-devices: multi-device runs are not ported yet (ROADMAP A6)"
        )


# ---------------------------------------------------------------- flagship

def _matches_from_intervals(ivl: IntervalList):
    """Extract ungapped multi-matches from an interval list: maximal gapless
    column runs where every present row has a base (the --lcb-match-input
    re-entry semantics, src/mauveAligner.cpp:504-514)."""
    from mauvealigner_tpu_torch.core.match import MatchList

    rows, lens = [], []
    n = ivl.n_seqs
    for iv in ivl.intervals:
        present = iv.starts != 0
        if present.sum() < 2:
            continue
        T = iv.aln.shape[1]
        pos = np.zeros((n, T), np.int64)
        for g in np.nonzero(present)[0]:
            s = int(iv.starts[g])
            mask = iv.aln[g]
            m = int(mask.sum())
            pos[g, mask] = (
                np.arange(s, s + m)
                if s > 0
                else -(np.arange(abs(s) + m - 1, abs(s) - 1, -1))
            )
        full = iv.aln[present].all(axis=0)
        d = np.diff(np.concatenate([[0], full.view(np.int8), [0]]))
        for s0, e0 in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            if e0 <= s0:
                continue
            row = np.zeros(n, np.int64)
            for g in np.nonzero(present)[0]:
                pg = pos[g, s0:e0]
                row[g] = int(pg[0]) if pg[0] > 0 else -abs(int(pg[-1]))
            rows.append(row)
            lens.append(e0 - s0)
    if not rows:
        return MatchList(np.zeros((0, n), np.int64), np.zeros(0, np.int64))
    return MatchList(np.stack(rows), np.asarray(lens, np.int64))


@tool("mauveAligner")
def mauve_aligner_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="mauveAligner",
        description="Multi-genome alignment via unique multi-MUM anchoring "
        "(reference: src/mauveAligner.cpp)",
    )
    p.add_argument("seqs", nargs="+", help="sequence files (FASTA/GenBank/raw)")
    p.add_argument("--output", default="-", help="match list output")
    p.add_argument("--output-alignment", default="", help="XMFA output file")
    p.add_argument("--mums", action="store_true", help="find MUMs only, no alignment")
    p.add_argument("--seed-size", type=int, default=0)
    p.add_argument(
        "--seed-type",
        default="spaced",
        choices=["solid", "coding", "spaced", "spaced1", "spaced2"],
    )
    p.add_argument("--weight", type=float, default=None, help="minimum LCB weight")
    p.add_argument("--no-recursion", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="multi-device runs are not ported yet (ROADMAP A6); "
                   "above 1 raises")
    p.add_argument("--no-lcb-extension", action="store_true",
                   help="skip the LCB extension phase")
    p.add_argument("--max-extension-iterations", type=int, default=4,
                   help="LCB extension passes (src/mauveAligner.cpp:879)")
    p.add_argument("--min-recursive-gap-length", type=int, default=200,
                   help="minimum gap size to recurse into (src/mauveAligner.cpp:899)")
    p.add_argument("--no-gapped-alignment", action="store_true")
    p.add_argument("--collinear", action="store_true")
    p.add_argument("--no-nway-filter", action="store_true", help="keep subset matches")
    p.add_argument("--eliminate-overlaps", action="store_true",
                   help="(--mums) eliminate overlapping match regions before output")
    p.add_argument("--n-way-filter", action="store_true",
                   help="(--mums) keep only matches in all genomes")
    p.add_argument("--coverage-output", nargs="?", const="-", default="",
                   help="(--mums) write a pairwise match coverage list")
    p.add_argument("--output-guide-tree", default="",
                   help="(--mums) write a coverage-distance NJ guide tree")
    p.add_argument("--alignment-output-dir", default="",
                   help="write per-LCB alignment files into this directory")
    p.add_argument("--permutation-matrix-min-weight", type=float, default=None,
                   help="minimum LCB weight for the permutation output "
                   "(scaled by sequence count, src/mauveAligner.cpp:682-685)")
    p.add_argument("--muscle-args", default="",
                   help="accepted for reference compatibility; gapped "
                   "alignment is on-device DP, no MUSCLE subprocess")
    p.add_argument("--island-break-min", type=int, default=0,
                   help="accepted; declared but never consumed in the "
                   "reference (src/mauveAligner.cpp:123,313)")
    p.add_argument("--id-matrix-input", default="",
                   help="accepted; dead in the reference (its option handler "
                   "falls through, src/mauveAligner.cpp:370-372)")
    p.add_argument("--lcb-match-input", action="store_true",
                   help="--match-input file is an interval (.mln) file; "
                   "extract its ungapped matches (src/mauveAligner.cpp:504-514)")
    p.add_argument("--version", action="version",
                   version="%(prog)s (mauvealigner_tpu_torch)")
    p.add_argument("--max-gapped-aligner-length", type=int, default=4096)
    p.add_argument("--island-size", type=int, default=0)
    p.add_argument("--island-output", default="")
    p.add_argument("--backbone-size", type=int, default=0)
    p.add_argument("--max-backbone-gap", type=int, default=0)
    p.add_argument("--backbone-output", default="")
    p.add_argument("--id-matrix", default="", help="identity matrix output file")
    p.add_argument("--permutation-matrix-output", default="")
    p.add_argument("--alignment-output-format", default="xmfa")
    p.add_argument("--match-input", default="", help="read matches from a file")
    p.add_argument("--lcb-input", default="", help="read intervals, skip search")
    p.add_argument("--match-log", default="", help="journal matches per partition")
    p.add_argument("--offset-log", default="", help="journal completed partitions")
    p.add_argument("--merge-match-log", default="", action="append",
                   help="merge an external match journal (repeatable)")
    p.add_argument("--partitions", type=int, default=1,
                   help="seed-space partitions for resumable search")
    p.add_argument("--realign-lcb", type=int, action="append", default=[],
                   help="re-align only the given LCB index (repeatable)")
    p.add_argument("--scratch-path", default="", help="SML scratch directory")
    p.add_argument("--repeats", action="store_true",
                   help="generate a repeat match list instead of aligning")
    p.add_argument("--rmin", type=int, default=2)
    p.add_argument("--rmax", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu the "
                   "plain-torch versions (no fallback between them)")
    p.add_argument("--debug", action="store_true",
                   help="perform internal consistency checks (very slow)")
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall-clock and GCUPS to stderr")
    a = p.parse_args(argv)

    from mauvealigner_tpu_torch.core import mln
    from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
    from mauvealigner_tpu_torch.seeds import CODING_SEED, SOLID_SEED

    rank = {"solid": SOLID_SEED, "coding": CODING_SEED, "spaced": 0, "spaced1": 1, "spaced2": 2}[
        a.seed_type
    ]
    genomes = load_genomes(a.seqs)
    if (a.island_size != 0) != (a.island_output != ""):
        p.error("Both --island-output and --island-size must be specified")
    _no_mesh(a.mesh_devices)
    opts = AlignerOptions(
        seed_size=a.seed_size,
        seed_rank=rank,
        lcb_weight=a.weight,
        collinear=a.collinear,
        recursive=not a.no_recursion,
        min_recursion_gap=a.min_recursive_gap_length,
        lcb_extension=not a.no_lcb_extension,
        max_extension_iters=a.max_extension_iterations,
        gapped=not a.no_gapped_alignment,
        max_gapped_len=a.max_gapped_aligner_length,
        nway_filter=not a.no_nway_filter,
        debug=a.debug,
        device=a.device,
    )
    if a.repeats:
        # RepeatHash mode: every seed occurrence participates
        # (src/mauveAligner.cpp:480-487).  Multiple genomes are searched in a
        # concatenated coordinate space (the reference's RepeatHashCat
        # intent, src/RepeatHashCat.h:10-21).
        from mauvealigner_tpu_torch.core.sml import build_sml
        from mauvealigner_tpu_torch.genome.sequence import Genome as _G
        from mauvealigner_tpu_torch.models.aligner import resolve_device
        from mauvealigner_tpu_torch.ops import matchops
        from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed

        if len(genomes) == 1:
            cat = genomes[0]
        else:
            cat = _G(np.concatenate([g.seq for g in genomes]), name="concat")
        seed = get_seed(a.seed_size or default_mer_size(len(cat)), rank)
        dev = resolve_device(a.device)
        groups = matchops.build_seed_groups([build_sml(cat, seed, dev)], dev)
        reps = matchops.repeat_matches_from_groups(
            groups, seed.length, min_multi=a.rmin, max_multi=a.rmax
        )
        with open_out(a.output) as fh:
            mln.write_match_list(reps, fh, a.seqs, [len(g) for g in genomes])
        return 0
    if a.scratch_path:
        from mauvealigner_tpu_torch.core.sml import register_temp_path

        register_temp_path(a.scratch_path)
    aligner = MauveAligner(opts)

    def _find_matches():
        from mauvealigner_tpu_torch.models import resume
        from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed

        if a.match_input:
            if a.lcb_match_input:
                # interval-file match input: extract the ungapped matches of
                # every LCB (src/mauveAligner.cpp:504-514)
                ivl_in = mln.read_interval_list(a.match_input, genomes)
                ml = _matches_from_intervals(ivl_in)
            else:
                ml, _, _ = mln.read_match_list(a.match_input)
            aligner._seed_weight = a.seed_size or default_mer_size(
                int(np.mean([len(g) for g in genomes]))
            )
        elif a.partitions > 1 or a.match_log or a.offset_log:
            avg = int(np.mean([len(g) for g in genomes]))
            weight = a.seed_size or default_mer_size(avg)
            aligner._seed_weight = weight
            ml = resume.resumable_find_mums(
                genomes,
                get_seed(weight, rank),
                n_partitions=max(a.partitions, 1),
                match_log=a.match_log,
                offset_log=a.offset_log,
                device=aligner.device,
            )
        else:
            ml = aligner.find_mums(genomes)
        if a.merge_match_log:
            ml = resume.merge_match_logs(ml, a.merge_match_log)
        return ml

    if a.mums:
        ml = _find_matches()
        if a.eliminate_overlaps:
            ml = ml.eliminate_overlaps()
        if a.n_way_filter:
            ml = ml.multiplicity_filter(len(genomes))
        with open_out(a.output) as fh:
            mln.write_match_list(ml, fh, a.seqs, [len(g) for g in genomes])
        if a.output_guide_tree or a.coverage_output:
            # count each base pair once (src/mauveAligner.cpp:611-614)
            cov_ml = ml if a.eliminate_overlaps else ml.eliminate_overlaps()
            from mauvealigner_tpu_torch.analysis.distance import coverage_distance_matrix

            dist = coverage_distance_matrix(cov_ml, [len(g) for g in genomes])
            if a.coverage_output:
                with open_out(a.coverage_output) as fh:
                    n = len(genomes)
                    for i in range(n):
                        for j in range(i + 1, n):
                            fh.write(f"{i}\t{j}\t{1.0 - dist[i, j]:.6f}\n")
            if a.output_guide_tree:
                from mauvealigner_tpu_torch.analysis.tree import neighbor_joining, write_newick

                tree = neighbor_joining(dist, [str(i) for i in range(len(genomes))])
                with open(a.output_guide_tree, "w") as fh:
                    fh.write(write_newick(tree) + "\n")
        return 0
    if a.lcb_input:
        ivl = mln.read_interval_list(a.lcb_input, genomes)
        if a.output_alignment:
            ivl.seq_filenames = list(a.seqs)
            ivl.write_xmfa(a.output_alignment)
        return 0

    from mauvealigner_tpu_torch.utils import timing

    # the phases of MauveAligner.align, timed for --profile
    with timing.GLOBAL.phase("anchoring"):
        ml = _find_matches()
    with timing.GLOBAL.phase("lcb_determination"):
        ml, lcbs = aligner.determine_lcbs(genomes, ml)
    if opts.lcb_extension:
        with timing.GLOBAL.phase("lcb_extension"):
            ml, lcbs = aligner.extend_lcbs(genomes, ml, lcbs)
    if opts.recursive:
        with timing.GLOBAL.phase("recursive_anchoring"):
            ml, lcbs = aligner.recursive_anchor(genomes, ml, lcbs)
    if a.realign_lcb:
        from mauvealigner_tpu_torch.models import resume

        ivl = resume.realign_lcbs(aligner, genomes, ml, lcbs, a.realign_lcb)
        if a.output_alignment:
            ivl.seq_filenames = list(a.seqs)
            ivl.write_xmfa(a.output_alignment)
        return 0
    from mauvealigner_tpu_torch.models.aligner import AlignmentResult

    with timing.GLOBAL.phase("gapped_closure"):
        res = AlignmentResult(aligner.build_intervals(genomes, ml, lcbs), lcbs, ml)
    with timing.GLOBAL.phase("outputs"):
        with open_out(a.output) as fh:
            mln.write_match_list(res.mums, fh, a.seqs, [len(g) for g in genomes])
        if a.output_alignment:
            # always XMFA (WriteStandardAlignment, src/mauveAligner.cpp:746-760);
            # --alignment-output-format applies to the per-LCB dir output only
            res.interval_list.seq_filenames = list(a.seqs)
            res.interval_list.write_xmfa(a.output_alignment)
        if a.id_matrix:
            from mauvealigner_tpu_torch.analysis.distance import identity_matrix, write_matrix

            write_matrix(identity_matrix(res.interval_list, genomes), a.id_matrix)
        if a.alignment_output_dir:
            from mauvealigner_tpu_torch.tools.convert import write_clustal, write_phylip

            os.makedirs(a.alignment_output_dir, exist_ok=True)
            fmt = a.alignment_output_format.lower()
            for li, iv in enumerate(res.interval_list.intervals):
                sub = IntervalList(genomes=list(genomes), intervals=[iv],
                                   seq_filenames=list(a.seqs))
                path = os.path.join(a.alignment_output_dir, f"lcb_{li}.txt")
                if fmt == "clustal":
                    with open(path, "w") as fh:
                        write_clustal(sub, fh)
                elif fmt == "phylip":
                    with open(path, "w") as fh:
                        write_phylip(sub, fh)
                elif fmt == "mfa":
                    with open(path, "w") as fh:
                        for s in range(iv.n_seqs):
                            if iv.starts[s] == 0:
                                continue
                            write_fasta_row(fh, sub.filenames()[s] or f"seq{s}",
                                            iv.aligned_text(genomes, s))
                else:
                    sub.write_xmfa(path)
        if a.permutation_matrix_output:
            from mauvealigner_tpu_torch.tools.convert import lcb_signed_permutations

            perm_lcbs = res.lcbs
            if a.permutation_matrix_min_weight is not None:
                # scaled by sequence count like SetPermutationOutput
                # (src/mauveAligner.cpp:682-685)
                min_w = a.permutation_matrix_min_weight * len(genomes)
                perm_lcbs = [l for l in perm_lcbs if l.weight >= min_w]
            with open(a.permutation_matrix_output, "w") as fh:
                for perm in lcb_signed_permutations(perm_lcbs):
                    fh.write("\t".join(str(v) for v in perm) + "\n")
        if a.island_output and a.island_size:
            from mauvealigner_tpu_torch.analysis.islands import (
                find_islands_between_lcbs,
                simple_find_islands,
            )

            with open(a.island_output, "w") as fh:
                for isl in simple_find_islands(res.interval_list, a.island_size):
                    fh.write(
                        f"{isl.seq_i}\t{isl.left_i}\t{isl.right_i}\t"
                        f"{isl.seq_j}\t{isl.left_j}\t{isl.right_j}\n"
                    )
                for seq, left, right in find_islands_between_lcbs(
                    res.interval_list, [len(g) for g in genomes], a.island_size
                ):
                    fh.write(f"{seq}\t{left}\t{right}\n")
        if a.backbone_output and a.backbone_size:
            from mauvealigner_tpu_torch.analysis.islands import simple_find_backbone, write_backbone

            segs = simple_find_backbone(
                res.interval_list, a.backbone_size, a.max_backbone_gap or a.backbone_size
            )
            write_backbone(segs, a.backbone_output, len(genomes))
    if a.profile:
        sys.stderr.write(timing.GLOBAL.report())
    return 0


@tool("progressiveMauve")
def progressive_mauve_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="progressiveMauve",
        description="Progressive multiple genome alignment with homology HMM "
        "backbone (reference: src/progressiveMauve.cpp)",
    )
    p.add_argument("seqs", nargs="+")
    p.add_argument("--output", required=True, help="XMFA output")
    p.add_argument("--seed-weight", type=int, default=0)
    p.add_argument("--solid-seeds", action="store_true")
    p.add_argument("--coding-seeds", action="store_true")
    p.add_argument("--seed-family", action="store_true")
    p.add_argument("--collinear", action="store_true")
    p.add_argument("--mums", action="store_true")
    p.add_argument("--skip-gapped-alignment", action="store_true")
    p.add_argument("--skip-refinement", action="store_true")
    p.add_argument("--refine-mode", choices=("split", "rebuild"),
                   default="split",
                   help="window refinement: one root-edge profile DP per window (split) or full per-window rebuild along the merge plan (rebuild)")
    p.add_argument("--profile-closure", action="store_true",
                   help="node-merge gap placement scores TRUE clade count "
                   "profiles (mean-of-pairs) instead of consensus codes")
    p.add_argument("--lca-member-scoring", action="store_true",
                   help="node-merge closure scores the closest cross-clade "
                   "extant pair's codes (consensus-backed)")
    p.add_argument("--no-tree-prune", action="store_true",
                   help="keep short private (occupancy-1) column runs in "
                   "internal node profiles (default: pruned; the "
                   "divergence-tail accuracy fix)")
    p.add_argument("--tree-prune-max-run", type=int, default=20,
                   help="longest occupancy-1 column run pruned from internal "
                   "node profiles (longer runs ride along as potential "
                   "clade-specific islands)")
    p.add_argument("--no-backbone", "--disable-backbone", dest="no_backbone",
                   action="store_true")
    p.add_argument("--backbone-output", default="")
    p.add_argument("--bbcols-output", default="")
    p.add_argument("--island-gap-size", type=int, default=20)
    p.add_argument("--hmm-identity", type=float, default=0.7)
    p.add_argument("--hmm-p-go-homologous", type=float, default=1e-5)
    p.add_argument("--hmm-p-go-unrelated", type=float, default=1e-9)
    p.add_argument("--input-guide-tree", default="")
    p.add_argument("--output-guide-tree", default="")
    p.add_argument("--scratch-path-1", default="",
                   help="directory for the SML cache when the sequence "
                   "directory cannot be written")
    p.add_argument("--scratch-path-2", default="",
                   help="a second such directory")
    p.add_argument("--apply-backbone", default="",
                   help="re-enter with an existing alignment: apply the given "
                   ".bbcols backbone to the input XMFA (first positional arg)")
    p.add_argument("--max-gapped-aligner-length", type=int, default=4096)
    p.add_argument("--scoring-scheme", default="sp",
                   choices=["sp", "ancestral", "sp_ancestral", "length"],
                   help="anchor scoring scheme (src/progressiveMauve.cpp:611-625)")
    p.add_argument("--no-weight-scaling", action="store_true",
                   help="disable pairwise-distance LCB weight scaling")
    p.add_argument("--conservation-distance-scale", type=float, default=0.5)
    p.add_argument("--max-breakpoint-distance-scale", "--bp-dist-scale",
                   dest="bp_dist_scale", type=float, default=0.5)
    p.add_argument("--weight", "--breakpoint-penalty", dest="breakpoint_penalty",
                   type=float, default=None,
                   help="explicit minimum LCB weight (sp-score units)")
    p.add_argument("--min-scaled-penalty", type=float, default=None,
                   help="floor for the scaled breakpoint penalty")
    p.add_argument("--bp-dist-estimate-min-score", type=float, default=None,
                   help="accepted for reference compatibility; pairwise distances "
                   "here come from match coverage, not a scored estimate")
    p.add_argument("--gap-open", type=float, default=None)
    p.add_argument("--gap-extend", type=float, default=None)
    p.add_argument("--substitution-matrix", default="",
                   help="NCBI-format substitution matrix file")
    p.add_argument("--muscle-args", default="",
                   help="accepted for reference compatibility; no MUSCLE "
                   "subprocess exists (gapped alignment is on-device DP)")
    p.add_argument("--penalize-repeats", action="store_true",
                   help="accepted for reference compatibility; anchors here are "
                   "unique MUMs so repeat penalization does not apply")
    p.add_argument("--repeat-penalty", choices=["negative", "zero"],
                   default="negative",
                   help="accepted for reference compatibility (anchors here "
                   "are unique MUMs, src/progressiveMauve.cpp:295)")
    p.add_argument("--no-recursion", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="multi-device runs are not ported yet (ROADMAP A6); "
                   "above 1 raises")
    p.add_argument("--tree-progressive", choices=["auto", "0", "1"],
                   default="auto",
                   help="per-node consensus-profile anchoring up the guide "
                   "tree (the reference's progressive anchoring semantics); "
                   "auto enables it when n-way anchor coverage is poor")
    p.add_argument("--no-boundary-extension", action="store_true",
                   help="disable gapped extension of LCB boundaries into "
                   "unanchored flanks")
    p.add_argument("--max-extension-flank", type=int, default=1024,
                   help="per-edge cap on gapped boundary extension")
    p.add_argument("--match-input", default="",
                   help="read matches from a file, skip the anchor search")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu the "
                   "plain-torch versions (no fallback between them)")
    p.add_argument("--version", action="version",
                   version="%(prog)s (mauvealigner_tpu_torch)")
    p.add_argument("--disable-cache", action="store_true",
                   help="do not read or write the sorted-mer-list cache files "
                   "(<seqfile>.<pattern>.sslist.npz) beside the inputs")
    p.add_argument("--mem-clean", action="store_true", help="accepted; no-op")
    p.add_argument("--debug", action="store_true",
                   help="perform internal consistency checks (very slow)")
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall-clock and GCUPS to stderr")
    a = p.parse_args(argv)

    from mauvealigner_tpu_torch.core import mln
    from mauvealigner_tpu_torch.core.sml import register_temp_path
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions

    for path in (a.scratch_path_1, a.scratch_path_2):
        if path:
            register_temp_path(path)
    if a.apply_backbone:
        # phase re-entry (src/progressiveMauve.cpp:367-385 style): apply an
        # existing backbone to an existing alignment
        from mauvealigner_tpu_torch.analysis.backbone import (
            apply_backbone,
            read_backbone_cols_file,
        )

        ivl = _read_alignment(a.seqs[0], a.seqs[1:])
        segs = read_backbone_cols_file(a.apply_backbone)
        applied = apply_backbone(ivl, segs)
        applied.write_xmfa(a.output)
        return 0
    _no_mesh(a.mesh_devices)
    genomes = load_genomes(a.seqs)
    opts = ProgressiveOptions(
        tree_progressive={"auto": None, "0": False, "1": True}[a.tree_progressive],
        seed_weight=a.seed_weight,
        solid_seeds=a.solid_seeds,
        coding_seeds=a.coding_seeds or not a.solid_seeds,
        seed_family=a.seed_family,
        collinear=a.collinear,
        scoring_scheme=a.scoring_scheme,
        lcb_weight_scaling=not a.no_weight_scaling,
        conservation_scale=a.conservation_distance_scale,
        breakpoint_scale=a.bp_dist_scale,
        breakpoint_penalty=a.breakpoint_penalty,
        min_scaled_penalty=a.min_scaled_penalty,
        recursive=not a.no_recursion,
        gapped=not a.skip_gapped_alignment,
        max_gapped_len=a.max_gapped_aligner_length,
        refine=not a.skip_refinement,
        refine_mode=a.refine_mode,
        boundary_extension=not a.no_boundary_extension,
        max_extension_flank=a.max_extension_flank,
        skip_backbone=a.no_backbone,
        island_gap_size=a.island_gap_size,
        hmm_identity=a.hmm_identity,
        hmm_p_go_homologous=a.hmm_p_go_homologous,
        hmm_p_go_unrelated=a.hmm_p_go_unrelated,
        input_guide_tree=a.input_guide_tree or None,
        output_guide_tree=a.output_guide_tree or (a.output + ".guide_tree"),
        profile_closure=a.profile_closure,
        lca_member_scoring=a.lca_member_scoring,
        tree_prune_private=not a.no_tree_prune,
        tree_prune_max_run=a.tree_prune_max_run,
        use_sml_cache=not a.disable_cache,
        device=a.device,
    )
    if a.gap_open is not None:
        opts.gap_open = a.gap_open
    if a.gap_extend is not None:
        # the reference's --gap-extend writes opt_gap_open
        # (src/progressiveMauve.cpp:673); that bug is deliberately NOT kept
        opts.gap_extend = a.gap_extend
    if a.substitution_matrix:
        from mauvealigner_tpu_torch.ops.dp import read_substitution_matrix

        opts.subst = read_substitution_matrix(a.substitution_matrix)
    if a.muscle_args:
        sys.stderr.write("--muscle-args ignored: gapped alignment is on-device DP\n")
    pm = ProgressiveMauve(opts)
    if a.mums:
        ml = pm.find_matches(genomes)
        with open_out(a.output) as fh:
            mln.write_match_list(ml, fh, a.seqs, [len(g) for g in genomes])
        return 0
    matches = None
    if a.match_input:
        with open(a.match_input) as fh:
            matches, _, _ = mln.read_match_list(fh)
    res = pm.align(genomes, matches=matches)
    res.interval_list.seq_filenames = list(a.seqs)
    from mauvealigner_tpu_torch.analysis import backbone as bbmod

    bb_name = a.backbone_output or (a.output + ".backbone")
    cols_name = a.bbcols_output or (a.output + ".bbcols")
    if len(res.backbone_rows):
        bbmod.write_backbone_seq_file(res.backbone_rows, bb_name, len(genomes))
        bbmod.write_backbone_cols_file(res.backbone_segments, cols_name)
        res.interval_list.backbone_filename = cols_name
    res.interval_list.write_xmfa(a.output)
    if a.profile:
        from mauvealigner_tpu_torch.utils import timing

        sys.stderr.write(timing.GLOBAL.report())
    return 0


@tool("repeatoire")
def repeatoire_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="repeatoire",
        description="De-novo repeat family detection by chained local "
        "multiple alignment (reference: src/repeatoire.cpp)",
    )

    def _bool(s: str) -> bool:
        return s.lower() not in ("0", "false", "no")

    p.add_argument("--sequence", required=True)
    p.add_argument("--z", type=int, default=0, help="seed weight")
    p.add_argument("--rmin", type=int, default=2)
    p.add_argument("--rmax", type=int, default=500)
    p.add_argument("--onlydirect", nargs="?", type=_bool, const=True,
                   default=False, help="only same-strand seed matches")
    p.add_argument("--minreplen", "--l", dest="minreplen", type=int, default=1,
                   help="minimum repeat length (reference --l, default 1)")
    p.add_argument("--no-extend", action="store_true")
    p.add_argument("--extend", type=_bool, default=True,
                   help="perform gapped extension on chains (default 1)")
    p.add_argument("--chain", type=_bool, default=True,
                   help="chain seeds (default 1)")
    p.add_argument("--allow-redundant", type=_bool, default=True,
                   help="allow redundant alignments (default 1; 0 crops "
                   "per-nucleotide overlaps, src/repeatoire.cpp:2538-2658)")
    p.add_argument("--large-repeats", type=_bool, default=False,
                   help="optimize for large repeats (crop order by length)")
    p.add_argument("--small-repeats", type=_bool, default=False,
                   help="optimize for small repeats")
    p.add_argument("--onlyextended", type=_bool, default=False,
                   help="only output extended matches")
    p.add_argument("--window", type=int, default=-1,
                   help="gapped-extension window override (-1 = 80*e^(-0.01m))")
    p.add_argument("--w", type=int, default=0,
                   help="neighborhood window (0 = seed_weight*3)")
    p.add_argument("--gapopen", type=float, default=0,
                   help="gap open penalty (0 = hoxd default -100)")
    p.add_argument("--gapextend", type=float, default=0,
                   help="gap extension penalty (0 = hoxd default -20)")
    p.add_argument("--h", type=float, default=0.008, dest="go_homo",
                   help="HMM transition to Homologous")
    p.add_argument("--u", type=float, default=0.001, dest="go_unrel",
                   help="HMM transition to Unrelated")
    p.add_argument("--percentid", type=float, default=0.0,
                   help="min repeat family %% id (adapts HMM emissions)")
    p.add_argument("--sp", type=float, default=0.0,
                   help="minimum Sum-of-Pairs alignment score")
    p.add_argument("--tandem", type=_bool, default=True,
                   help="allow tandem repeats (default 1)")
    p.add_argument("--two-hits", type=_bool, default=False,
                   help="require two chained hits to trigger gapped extension")
    p.add_argument("--novel-matches", type=_bool, default=True,
                   help="use novel matches found during gapped extension "
                        "(src/repeatoire.cpp:1726)")
    p.add_argument("--solid", type=_bool, default=False,
                   help="use solid/exact seeds")
    p.add_argument("--load-sml", type=_bool, default=False,
                   help="reuse the on-disk SML cache")
    p.add_argument("--unalign", type=_bool, default=True,
                   help="accepted for reference compatibility (the flag is "
                   "declared but never consumed in src/repeatoire.cpp)")
    p.add_argument("--novel-subsets", nargs="?", type=_bool, const=True,
                   default=False,
                   help="find novel subset matches (reference default false, "
                   "src/repeatoire.cpp:1725)")
    p.add_argument("--seeds", default="", help="seed (chained match) output file")
    p.add_argument("--score-out", default="",
                   help="per-family score and alignment info output")
    p.add_argument("--output", "--xmfa", dest="output", default="reps.xmfa",
                   help="XMFA output")
    p.add_argument("--xml", default="", help="XML output")
    p.add_argument("--highest", default="procrast.highest",
                   help="per-multiplicity stats output")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu the "
                   "plain-torch versions (no fallback between them)")
    a = p.parse_args(argv)

    from mauvealigner_tpu_torch.core.mln import write_match_list
    from mauvealigner_tpu_torch.models.repeatoire import (
        Repeatoire,
        RepeatoireOptions,
        write_highest_stats,
        write_repeats_xmfa,
        write_repeats_xml,
        write_score_out,
    )

    genome = load_genome(a.sequence)
    opts = RepeatoireOptions(
        z=a.z,
        rmin=a.rmin,
        rmax=a.rmax,
        only_direct=a.onlydirect,
        min_length=a.minreplen,
        extend=a.extend and not a.no_extend,
        chain=a.chain,
        allow_redundant=a.allow_redundant,
        large_repeats=a.large_repeats,
        small_repeats=a.small_repeats,
        only_extended=a.onlyextended,
        window=a.window,
        w=a.w,
        min_sp_score=a.sp,
        allow_tandem=a.tandem,
        two_hits=a.two_hits,
        use_novel_matches=a.novel_matches,
        solid=a.solid,
        load_sml=a.load_sml,
        percent_id=a.percentid,
        hmm_go_homologous=a.go_homo,
        hmm_go_unrelated=a.go_unrel,
        find_novel_subsets=a.novel_subsets,
        device=a.device,
    )
    if a.gapopen:
        opts.gap_open = -abs(a.gapopen)
    if a.gapextend:
        opts.gap_extend = -abs(a.gapextend)
    rp = Repeatoire(opts)
    matches = None
    if a.seeds:
        ml = rp.seed_matches(genome)
        seed_counts = None
        if opts.chain:
            ml, seed_counts = rp.chain_seed_matches(ml, genome)
        write_match_list(ml, a.seeds, [genome.name], [len(genome)])
        matches = (ml, seed_counts)
    fams = rp.find_repeats(genome, matches=matches)
    write_repeats_xmfa(fams, genome, a.output)
    if a.xml:
        write_repeats_xml(fams, genome, a.xml)
    if a.highest:
        write_highest_stats(fams, a.highest)
    if a.score_out:
        write_score_out(fams, genome, a.score_out)
    print(f"{len(fams)} repeat families")
    return 0


@tool("scoreProcrastAlignment")
def score_procrast_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="scoreProcrastAlignment",
        description="Score a calculated repeat alignment against a correct "
        "one (reference: src/scoreProcrastAlignment.cpp)",
    )
    p.add_argument("correct")
    p.add_argument("calculated")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.repeat_score import score_procrast_alignment
    from mauvealigner_tpu_torch.models.repeatoire import read_repeats_xmfa

    score = score_procrast_alignment(
        read_repeats_xmfa(a.correct), read_repeats_xmfa(a.calculated)
    )
    # reference output labels (src/scoreProcrastAlignment.cpp:246-257)
    print(f"sp_truepos {score.tp}")
    print(f"sp_possible {score.tp + score.fn}")
    print(f"SP sensitivity: {score.sensitivity:.6g}")
    print(f"Match component PPV: {score.ppv:.6g}")
    return 0


@tool("scoreALU")
def score_alu_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="scoreALU",
        description="Validate repeat families against RepeatMasker "
        "annotations (reference: src/scoreALU.cpp)",
    )
    p.add_argument("repeats_xmfa")
    p.add_argument("repeatmasker_out")
    p.add_argument("--class-filter", default="Alu")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.repeat_score import parse_repeatmasker, score_alu
    from mauvealigner_tpu_torch.models.repeatoire import read_repeats_xmfa

    stats = score_alu(
        read_repeats_xmfa(a.repeats_xmfa),
        parse_repeatmasker(a.repeatmasker_out),
        a.class_filter,
    )
    print(json.dumps(stats))
    return 0


@tool("scoreAlignment")
def score_alignment_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="scoreAlignment",
        description="Score a calculated XMFA against a known-correct one "
        "(reference: src/scoreAlignment.cpp)",
    )
    p.add_argument("correct")
    p.add_argument("calculated")
    p.add_argument("seqs", nargs="*", help="sequence files (for lengths)")
    p.add_argument("--evolved-seqs", default="",
                   help="evolved sequence file: cross-check base identity of "
                   "the correct alignment (reference third arg, "
                   "src/scoreAlignment.cpp:106-113)")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.score_alignment import score_alignment

    correct = _read_alignment(a.correct, a.seqs)
    calculated = _read_alignment(a.calculated, a.seqs)
    lengths = [len(g) for g in correct.genomes]
    if not any(lengths):
        # reconstruct lengths from the correct alignment's coordinates
        lengths = [
            max(
                (int(iv.rights()[s]) for iv in correct.intervals if iv.starts[s] != 0),
                default=0,
            )
            for s in range(correct.n_seqs)
        ]
    score = score_alignment(correct, calculated, lengths)
    sys.stdout.write(score.summary())
    # reference-convention counter block (the reference binary's exact
    # Sensitivity/Specificity labeling, incl. its quirks — see
    # analysis/score_alignment.ReferenceCounters)
    from mauvealigner_tpu_torch.analysis.score_alignment import reference_counters

    sys.stdout.write(reference_counters(correct, calculated, lengths).summary())
    if a.evolved_seqs:
        from mauvealigner_tpu_torch.analysis.distance import identity_matrix
        from mauvealigner_tpu_torch.genome.fasta import read_fasta_records

        evolved = read_fasta_records(a.evolved_seqs)
        if len(evolved) == correct.n_seqs:
            correct.genomes = evolved
            ident = identity_matrix(correct, evolved)
            n = correct.n_seqs
            vals = [ident[i][j] for i in range(n) for j in range(i + 1, n)]
            sys.stdout.write(
                f"correct-alignment base identity (evolved seqs): "
                f"{float(np.mean(vals)):.4f}\n"
            )
    return 0


@tool("evd")
def evd_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="evd",
        description="EVD of score excursions (reference: src/evd.cpp).  "
        "With a run count, reads alignjob.N/evolved.dat simulations from "
        "the current directory (reference mode); otherwise simulates "
        "random unrelated pairs.",
    )
    p.add_argument("run_count", nargs="?", type=int, default=None,
                   help="number of alignjob.N directories (reference mode)")
    p.add_argument("--dir", default=".", help="directory holding alignjob.N")
    p.add_argument("--length", type=int, default=10000)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--gc", type=float, default=0.5)
    p.add_argument("--output", default="-")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.evd import (
        alignjob_heights,
        quantile_summary,
        simulate_evd,
    )

    with open_out(a.output) as fh:
        if a.run_count is not None:
            lrh, n_sims = alignjob_heights(a.run_count, a.dir)
            fh.write(quantile_summary(lrh, n_sims))
        else:
            fh.write(simulate_evd(a.length, a.trials, a.gc).summary())
    return 0


@tool("multiEVD")
def multi_evd_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="multiEVD",
        description="Aggregate EVD simulations (reference: src/multiEVD.cpp).  "
        "With a bare run count, reads alignjob.N directories and prints a "
        "per-multiplicity quantile table (reference mode); with file "
        "arguments, merges evd summary files.",
    )
    p.add_argument("evd_files", nargs="+",
                   help="alignjob run count OR evd summary files")
    p.add_argument("--dir", default=".", help="directory holding alignjob.N")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.evd import EvdResult, merge_evd_results

    if len(a.evd_files) == 1 and a.evd_files[0].isdigit():
        from mauvealigner_tpu_torch.analysis.evd import multi_evd_table

        sys.stdout.write(multi_evd_table(int(a.evd_files[0]), a.dir))
        return 0
    results = []
    for path in a.evd_files:
        vals = {}
        with open(path) as fh:
            for line in fh:
                if ":" in line:
                    k, v = line.split(":", 1)
                    vals[k.strip()] = float(v)
        results.append(
            EvdResult(
                int(vals.get("excursions", 0)),
                vals.get("mean record height", 0.0),
                vals.get("max record height", 0.0),
                vals.get("lambda", 0.0),
                vals.get("mu", 0.0),
            )
        )
    merged = merge_evd_results(results)
    sys.stdout.write(merged.summary())
    return 0


@tool("bbAnalyze")
def bb_analyze_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="bbAnalyze",
        description="Comparative backbone analysis report "
        "(reference: src/bbAnalyze.cpp)",
    )
    p.add_argument("backbone")
    p.add_argument("output")
    p.add_argument("--reference", default="", help="annotated GenBank reference")
    p.add_argument("--categories", default="", help="TSV: feature<TAB>category")
    p.add_argument("--annotated-index", type=int, default=0,
                   help="sequence index of the annotated genome (reference "
                        "positional 'annotated seq index', 0-based)")
    p.add_argument("--n-seqs", type=int, default=0)
    p.add_argument("--guide-tree", default="",
                   help="Newick guide tree: adds the per-node unique/hop/"
                        "core/pan analysis section (src/bbAnalyze.cpp:1342)")
    p.add_argument("--xmfa", default="",
                   help="alignment file (genome lengths enable faux "
                        "single-genome segments for unaligned regions)")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.backbone import read_backbone_seq_file
    from mauvealigner_tpu_torch.analysis.bb_analyze import (
        bb_analyze_report,
        tree_node_analysis,
        write_tree_analysis,
    )

    rows = read_backbone_seq_file(a.backbone)
    n_seqs = a.n_seqs or (len(rows[0]) // 2 if rows else 0)
    ref = load_genome(a.reference) if a.reference else None
    categories = {}
    if a.categories:
        with open(a.categories) as cf:
            for line in cf:
                toks = line.rstrip("\n").split("\t")
                if len(toks) >= 2:
                    categories[toks[0]] = toks[1]
    with open_out(a.output) as fh:
        bb_analyze_report(
            rows, n_seqs, ref, categories or None, fh,
            anno_index=a.annotated_index,
        )
        if a.guide_tree:
            from mauvealigner_tpu_torch.analysis.tree import parse_newick

            with open(a.guide_tree) as tf:
                tree = parse_newick(tf.read())
            for leaf in tree.leaves():
                nm = leaf.name
                if nm.isdigit():
                    idx = int(nm)
                elif nm.startswith("seq") and nm[3:].isdigit():
                    idx = int(nm[3:]) - 1  # reference seqN naming (1-based)
                else:
                    p.error(
                        f"guide-tree leaf {nm!r} is not a sequence index or "
                        "seqN name; rename leaves to 0..n-1 or seq1..seqN "
                        "(order-based guessing would silently misattribute "
                        "per-node statistics)"
                    )
                if not (0 <= idx < n_seqs):
                    p.error(
                        f"guide-tree leaf {nm!r} maps to sequence {idx}, "
                        f"outside 0..{n_seqs - 1}"
                    )
                leaf.name = str(idx)
            seq_lengths = None
            if a.xmfa:
                ivl = IntervalList.read_xmfa(a.xmfa)
                seq_lengths = [len(g) for g in ivl.genomes]
            summaries = tree_node_analysis(rows, n_seqs, tree, seq_lengths)
            write_tree_analysis(
                summaries, fh, reference=ref, ref_index=a.annotated_index,
                categories=categories or None,
            )
    return 0


@tool("bbBreakOnGenes")
def bb_break_on_genes_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="bbBreakOnGenes",
        description="Re-detect backbone from an alignment with a big-gaps "
        "detector, split on annotated gene boundaries "
        "(reference: src/bbBreakOnGenes.cpp:229-353).  Gene bounds come "
        "from one .ptt file per genome when given, else from CDS features "
        "of the alignment's (GenBank) sequence files.",
    )
    p.add_argument("xmfa")
    p.add_argument("min_bb_gap", type=int,
                   help="gap runs longer than this break homology")
    p.add_argument("output")
    p.add_argument("ptt", nargs="*",
                   help="optional .ptt gene tables, one per genome in "
                   "alignment order (src/bbBreakOnGenes.cpp:259-285)")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.analysis.backbone import write_backbone_seq_file
    from mauvealigner_tpu_torch.analysis.bb_analyze import (
        break_on_genes,
        gene_boundary_violations,
        genbank_gene_bounds,
        ptt_gene_bounds,
    )

    ivs = IntervalList.read_xmfa(a.xmfa)
    n = ivs.n_seqs
    if a.ptt and len(a.ptt) != n:
        p.error(f"got {len(a.ptt)} ptt files for {n} genomes")
    if a.ptt:
        gene_bounds = [ptt_gene_bounds(f) for f in a.ptt]
    else:
        genomes = load_genomes(ivs.filenames())
        ivs.genomes = genomes
        gene_bounds = [genbank_gene_bounds(g) for g in genomes]
        for i, g in enumerate(genomes):
            sys.stderr.write(
                f"Found {len(gene_bounds[i]) // 2} genes for "
                f"{ivs.filenames()[i]}\n"
            )
    rows = break_on_genes(ivs, a.min_bb_gap, gene_bounds)
    with open_out(a.output) as fh:
        write_backbone_seq_file(rows, fh, n)
    for msg in gene_boundary_violations(rows, gene_bounds):
        sys.stderr.write(msg + "\n")
    return 0


@tool("gappiness")
def gappiness_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="gappiness",
        description="Gap statistics of an aligned MFA "
        "(reference: src/gappiness.cpp)",
    )
    p.add_argument("mfa", help="aligned multi-FastA file")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records
    from mauvealigner_tpu_torch.tools.convert import gappiness_report

    rows = read_fasta_records(a.mfa)  # '-' characters survive the read
    gappiness_report(rows, sys.stdout)
    return 0


# ---------------------------------------------------------------- converters

@tool("xmfa2maf")
def xmfa2maf_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="xmfa2maf")
    p.add_argument("xmfa")
    p.add_argument("maf")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import xmfa2maf

    with open_out(a.maf) as fh:
        xmfa2maf(_read_alignment(a.xmfa, a.seq_files), fh)
    return 0


@tool("mfa2xmfa")
def mfa2xmfa_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="mfa2xmfa",
        description="MFA -> XMFA; the optional third argument writes the "
        "gap-stripped records as unaligned FastA "
        "(reference: src/mfa2xmfa.cpp:14,40-61)",
    )
    p.add_argument("mfa")
    p.add_argument("xmfa")
    p.add_argument("unaligned", nargs="?", default="",
                   help="unaligned FastA output (optional)")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records
    from mauvealigner_tpu_torch.tools.convert import mfa2xmfa

    records = read_fasta_records(a.mfa)
    with open_out(a.xmfa) as fh:
        mfa2xmfa(records, fh)
    if a.unaligned:
        with open_out(a.unaligned) as fh:
            for rec in records:
                seq = rec.seq[rec.seq != ord("-")]
                write_fasta_row(fh, rec.name, seq.tobytes().decode("ascii"))
    return 0


@tool("mauveToXMFA")
def mauve_to_xmfa_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="mauveToXMFA")
    p.add_argument("mln")
    p.add_argument("xmfa")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.core.mln import read_interval_list

    genomes = load_genomes(a.seq_files) if a.seq_files else None
    ivl = read_interval_list(a.mln, genomes)
    ivl.write_xmfa(a.xmfa)
    return 0


@tool("toMultiFastA")
def to_multi_fasta_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="toMultiFastA")
    p.add_argument("alignment")
    p.add_argument("prefix")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import to_multi_fasta

    names = to_multi_fasta(_read_alignment(a.alignment, a.seq_files), a.prefix)
    print("\n".join(names))
    return 0


@tool("toRawSequence")
def to_raw_sequence_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="toRawSequence")
    p.add_argument("seq")
    p.add_argument("raw_out")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import to_raw_sequence

    to_raw_sequence(load_genome(a.seq), a.raw_out)
    return 0


@tool("multiToRawSequence")
def multi_to_raw_sequence_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="multiToRawSequence")
    p.add_argument("mfa")
    p.add_argument("prefix")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.genome.fasta import read_fasta_records

    recs = read_fasta_records(a.mfa)
    for i, rec in enumerate(recs):
        rec.seq.tofile(f"{a.prefix}{i}.raw")
    return 0


@tool("toGBKsequence")
def to_gbk_sequence_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="toGBKsequence")
    p.add_argument("seq")
    p.add_argument("gbk_out")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import to_gbk_sequence

    with open_out(a.gbk_out) as fh:
        to_gbk_sequence(load_genome(a.seq), fh)
    return 0


def _lcbs_from_alignment(ivl: IntervalList):
    """Interpret each multiplicity>=2 interval as an LCB record."""
    from mauvealigner_tpu_torch.models.lcb import LCB

    lcbs = []
    for iv in ivl.intervals:
        if iv.multiplicity() < 2:
            continue
        lcbs.append(
            LCB(
                match_indices=np.zeros(0, np.int64),
                weight=int(iv.n_cols),
                lefts=iv.lefts(),
                rights=iv.rights(),
                strands=np.sign(iv.starts).astype(np.int8),
            )
        )
    return lcbs


def _chr_bounds(spec: str):
    """Per-genome cumulative chromosome ends from a comma-separated list of
    chromosome-length files, or None without one."""
    if not spec:
        return None
    bounds = []
    for path in spec.split(","):
        with open(path) as fh:
            bounds.append(np.cumsum([int(tok) for tok in fh.read().split()]).tolist())
    return bounds


@tool("toGrimmFormat")
def to_grimm_format_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="toGrimmFormat")
    p.add_argument("alignment")
    p.add_argument("output")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("--chr-lengths", default="",
                   help="comma-separated per-genome chromosome-length files "
                   "(multichromosomal GRIMM, src/toGrimmFormat.cpp:27-45); "
                   "without it, contig boundaries of the loaded sequences "
                   "are used when present")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import to_grimm_format

    ivl = _read_alignment(a.alignment, a.seq_files)
    chr_bounds = _chr_bounds(a.chr_lengths)
    if chr_bounds is None and any(len(g.contigs) > 1 for g in ivl.genomes):
        chr_bounds = [
            np.cumsum([c.length for c in g.contigs]).tolist() if len(g.contigs) > 1 else []
            for g in ivl.genomes
        ]
    with open_out(a.output) as fh:
        to_grimm_format(_lcbs_from_alignment(ivl), ivl.filenames(), fh, chr_bounds)
    return 0


@tool("toEvoHighwayFormat")
def to_evo_highway_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="toEvoHighwayFormat")
    p.add_argument("alignment")
    p.add_argument("output")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("--ref-id", type=int, default=0,
                   help="reference genome index (reference second arg)")
    p.add_argument("--chr-lengths", default="",
                   help="comma-separated per-genome chromosome-length files")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import to_evo_highway_format

    ivl = _read_alignment(a.alignment, a.seq_files)
    chr_bounds = _chr_bounds(a.chr_lengths)
    with open_out(a.output) as fh:
        to_evo_highway_format(
            _lcbs_from_alignment(ivl), ivl.filenames(),
            [len(g) for g in ivl.genomes], fh,
            ref_id=a.ref_id, chr_bounds=chr_bounds,
        )
    return 0


@tool("makeBadgerMatrix")
def make_badger_matrix_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="makeBadgerMatrix")
    p.add_argument("alignment")
    p.add_argument("output")
    p.add_argument("--lcb-coordinates", default="")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import make_badger_matrix

    ivl = _read_alignment(a.alignment, a.seq_files)
    with open_out(a.output) as fh:
        if a.lcb_coordinates:
            with open(a.lcb_coordinates, "w") as coords:
                make_badger_matrix(ivl, fh, coords)
        else:
            make_badger_matrix(ivl, fh, None)
    return 0


@tool("makeMc4Matrix")
def make_mc4_matrix_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="makeMc4Matrix")
    p.add_argument("alignment")
    p.add_argument("output")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import make_mc4_matrix

    ivl = _read_alignment(a.alignment, a.seq_files)
    with open_out(a.output) as fh:
        make_mc4_matrix(ivl, fh)
    return 0


@tool("countInPlaceInversions")
def count_in_place_inversions_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="countInPlaceInversions")
    p.add_argument("alignment")
    p.add_argument("seq_files", nargs="*")
    a = p.parse_args(argv)
    from mauvealigner_tpu_torch.tools.convert import find_in_place_inversions

    ivl = _read_alignment(a.alignment, a.seq_files)
    lcbs = _lcbs_from_alignment(ivl)
    for _, seq, lend, rend in find_in_place_inversions(lcbs):
        print(f"In-place inversion in seq {seq}\tlend: {lend}\trend: {rend}")
    return 0


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("available tools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0
    name = argv[0]
    if name not in TOOLS:
        print(f"unknown tool {name!r}; use --list", file=sys.stderr)
        return 2
    try:
        return TOOLS[name](argv[1:])
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed early — not an error
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
