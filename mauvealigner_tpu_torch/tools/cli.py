"""CLI of the port: the mauveAligner, progressiveMauve, repeatoire,
scoreProcrastAlignment and scoreALU subcommands.

Usage:  python -m mauvealigner_tpu_torch.tools mauveAligner a.fa b.fa \\
            --output-alignment=o.xmfa [--device=cuda]
        python -m mauvealigner_tpu_torch.tools progressiveMauve a.fa b.fa c.fa \\
            --output=o.xmfa [--device=cuda]
        python -m mauvealigner_tpu_torch.tools repeatoire --sequence=g.fa \\
            --output=reps.xmfa [--xml=reps.xml] [--device=cuda]
        python -m mauvealigner_tpu_torch.tools --list

Port of mauvealigner_tpu/tools/cli.py's mauveAligner alignment path
(src/mauveAligner.cpp: anchoring, LCBs, LCB extension, recursive anchoring,
gapped closure, the match list and the XMFA output), its progressiveMauve
subcommand (src/progressiveMauve.cpp: XMFA, .backbone, .bbcols and
.guide_tree outputs, --mums, --match-input, the SML disk cache), its
repeatoire subcommand (src/repeatoire.cpp: XMFA, XML, procrast.highest,
--score-out and --seeds outputs) and the two repeat scorers.  What is not
ported yet is listed in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List

from mauvealigner_tpu_torch.tools.common import load_genome, load_genomes, open_out

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn

    return deco


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
    p.add_argument("--seed-size", type=int, default=0)
    p.add_argument(
        "--seed-type",
        default="spaced",
        choices=["solid", "coding", "spaced", "spaced1", "spaced2"],
    )
    p.add_argument("--weight", type=float, default=None, help="minimum LCB weight")
    p.add_argument("--no-recursion", action="store_true")
    p.add_argument("--no-lcb-extension", action="store_true",
                   help="skip the LCB extension phase")
    p.add_argument("--max-extension-iterations", type=int, default=4,
                   help="LCB extension passes (src/mauveAligner.cpp:879)")
    p.add_argument("--min-recursive-gap-length", type=int, default=200,
                   help="minimum gap size to recurse into (src/mauveAligner.cpp:899)")
    p.add_argument("--no-gapped-alignment", action="store_true")
    p.add_argument("--collinear", action="store_true")
    p.add_argument("--no-nway-filter", action="store_true", help="keep subset matches")
    p.add_argument("--max-gapped-aligner-length", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu the "
                   "plain-torch versions (no fallback between them)")
    p.add_argument("--version", action="version",
                   version="%(prog)s (mauvealigner_tpu_torch)")
    p.add_argument("--debug", action="store_true",
                   help="perform internal consistency checks (very slow)")
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall-clock and GCUPS to stderr")
    a = p.parse_args(argv)

    from mauvealigner_tpu_torch.core import mln
    from mauvealigner_tpu_torch.models.aligner import (
        AlignerOptions,
        AlignmentResult,
        MauveAligner,
    )
    from mauvealigner_tpu_torch.seeds import CODING_SEED, SOLID_SEED

    rank = {"solid": SOLID_SEED, "coding": CODING_SEED, "spaced": 0, "spaced1": 1, "spaced2": 2}[
        a.seed_type
    ]
    genomes = load_genomes(a.seqs)
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
    aligner = MauveAligner(opts)
    ml = aligner.find_mums(genomes)
    ml, lcbs = aligner.determine_lcbs(genomes, ml)
    if opts.lcb_extension:
        ml, lcbs = aligner.extend_lcbs(genomes, ml, lcbs)
    if opts.recursive:
        ml, lcbs = aligner.recursive_anchor(genomes, ml, lcbs)
    res = AlignmentResult(aligner.build_intervals(genomes, ml, lcbs), lcbs, ml)
    with open_out(a.output) as fh:
        mln.write_match_list(res.mums, fh, a.seqs, [len(g) for g in genomes])
    if a.output_alignment:
        # always XMFA (WriteStandardAlignment, src/mauveAligner.cpp:746-760)
        res.interval_list.seq_filenames = list(a.seqs)
        res.interval_list.write_xmfa(a.output_alignment)
    if a.profile:
        from mauvealigner_tpu_torch.utils import timing

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
    p.add_argument("--apply-backbone", default="",
                   help="not ported yet (needs the XMFA reader of the tools "
                   "slice); raises")
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
                   help="multi-device runs are not ported yet; above 1 raises")
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
    from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve, ProgressiveOptions

    if a.apply_backbone:
        raise NotImplementedError(
            "--apply-backbone needs the XMFA reader, which comes with the tools "
            "(ROADMAP slice 4)"
        )
    if a.mesh_devices > 1:
        raise NotImplementedError("--mesh-devices: multi-device runs are slice 5 of the port")
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
