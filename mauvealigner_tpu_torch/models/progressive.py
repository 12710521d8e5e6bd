"""ProgressiveMauve: guide-tree progressive alignment with homology backbone
(port of mauvealigner_tpu/models/progressive.py; every device phase runs on
ProgressiveOptions.device).

Pipeline parity with doAlignment in src/progressiveMauve.cpp:265-723:

  1. coding-family spaced seeds by default (LoadSMLs(..., CODING_SEED),
     src/progressiveMauve.cpp:446-451), weight defaulted from average length;
  2. match finding: unique multi-MUMs (UniqueMatchFinder for >4 sequences,
     PairwiseMatchFinder otherwise, src/progressiveMauve.cpp:489-502); an
     optional seed-family pass searches all three family members
     longest-first (src/progressiveMauve.cpp:504-548);
  3. NJ guide tree from match-coverage distances (MuscleInterface::CreateTree
     equivalent; input/output guide tree files supported,
     src/progressiveMauve.cpp:689-692);
  4. LCBs via greedy breakpoint elimination with a scaled penalty
     (setBreakpointPenalty / scaling defaults 0.5/0.5,
     src/progressiveMauve.cpp:592,626-637) — round 1 uses the Mauve weight
     rule scaled by the conservation factor;
  5. recursive anchoring + gapped closure ordered by the guide tree
     (per-node profile alignment);
  6. homology-HMM backbone detection and application with the documented
     defaults pgh=1e-5 pgu=1e-9 identity=0.7 island_gap=20
     (src/progressiveMauve.cpp:319-322) and GC adaptation; `.backbone` and
     `.bbcols` outputs (applyBackbone, src/progressiveMauve.cpp:226-260).

Determinism: all randomness flows from DEFAULT_RANDOM_SEED=37
(SetTwisterSeed(37), src/progressiveMauve.cpp:355).

With use_sml_cache (the default) and genome file names, as the CLI always
has them, the anchor search goes through the on-disk sorted-mer-list cache
and the host seed-group path (core/sml.load_sml, matchops.find_multi_mums),
as in the JAX package; otherwise it takes the device search.  With a mesh
(ProgressiveOptions.mesh, a parallel.Mesh) the device search is the
sharded two-phase search and every batched kernel underneath (node-merge
anchoring, closure/refinement Gotoh, backbone HMM decode) splits its batch
over the mesh's shards; the output is the single-device run's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from mauvealigner_tpu_torch.analysis import backbone as bb
from mauvealigner_tpu_torch.analysis.distance import coverage_distance_matrix
from mauvealigner_tpu_torch.analysis.tree import (
    TreeNode,
    neighbor_joining,
    parse_newick,
    upgma,
    write_newick,
)
from mauvealigner_tpu_torch.core.interval import IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.core.sml import build_mer_list_device, build_sml, load_sml
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner, resolve_device
from mauvealigner_tpu_torch.models.lcb import LCB
from mauvealigner_tpu_torch.ops import dp, matchops
from mauvealigner_tpu_torch.seeds import CODING_SEED, default_seed_weight, get_seed, seed_family


@dataclasses.dataclass
class ProgressiveOptions:
    seed_weight: int = 0              # 0 = default_seed_weight(avg len)
    solid_seeds: bool = False
    coding_seeds: bool = True         # reference default (LoadSMLs CODING_SEED)
    seed_family: bool = False
    collinear: bool = False
    breakpoint_penalty: Optional[float] = None
    # anchor scoring scheme: "sp" (ExtantSumOfPairsScoring, the reference
    # default), "ancestral", "sp_ancestral", or "length" (original Mauve
    # length weights) — src/progressiveMauve.cpp:611-625
    scoring_scheme: str = "sp"
    lcb_weight_scaling: bool = True   # setUseLcbWeightScaling default
    conservation_scale: float = 0.5   # setConservationDistanceScale default
    breakpoint_scale: float = 0.5     # setBreakpointDistanceScale default
    recursive: bool = True
    gapped: bool = True
    max_gapped_len: int = 4096
    refine: bool = True               # iterative window refinement (setRefinement)
    refine_mode: str = "split"        # root-edge profile realign | "rebuild"
    subset_lcbs: bool = True          # clade-restricted subset-LCB recovery
    # gapped extension of LCB boundaries into unanchored flanks (the
    # reference's full-length alignment / LCB extension semantics,
    # src/mauveAligner.cpp:687-690; over-extension is stripped by the
    # homology HMM).  max_extension_flank caps the per-edge reach.
    boundary_extension: bool = True
    max_extension_flank: int = 1024
    skip_backbone: bool = False
    island_gap_size: int = 20         # src/progressiveMauve.cpp:322
    hmm_identity: float = 0.7         # :321
    hmm_p_go_homologous: float = 1e-5  # :319
    hmm_p_go_unrelated: float = 1e-9   # :320
    input_guide_tree: Optional[str] = None
    output_guide_tree: Optional[str] = None
    guide_tree_method: str = "upgma"  # "upgma" (MUSCLE UPGMB style) or "nj"
    gap_open: float = dp.DEFAULT_GAP_OPEN
    gap_extend: float = dp.DEFAULT_GAP_EXTEND
    subst: Optional[np.ndarray] = None  # custom 5x5 scores (--substitution-matrix)
    # floor for the scaled breakpoint penalty (setMinimumBreakpointPenalty,
    # src/progressiveMauve.cpp:648-651)
    min_scaled_penalty: Optional[float] = None
    # anchor search through the sorted-mer-list disk cache when the genomes
    # have file names (LoadSMLs, src/progressiveMauve.cpp:447-451)
    use_sml_cache: bool = True
    # true progressive anchoring up the guide tree: per-node pairwise
    # alignment of clade consensus representatives (the ancestral-profile
    # anchoring of src/progressiveMauve.cpp:575-710, consensus-ladder
    # redesign — models/tree_progressive.py).  Recovers sensitivity at high
    # divergence where full-multiplicity extant seeds vanish.  None = auto:
    # enable when the n-way anchors cover < tree_progressive_threshold of
    # the mean genome length (measured: coverage 0.28 at ~16% pairwise
    # divergence where the extant path still scores sn 0.98; 0.05 at ~24%
    # where it collapses to 0.75).
    tree_progressive: Optional[bool] = None
    tree_progressive_threshold: float = 0.15
    # profile-aware anchoring at internal tree nodes: union translated
    # extant anchors (closest cross-clade pair, lifted through the column
    # maps) into every non-leaf-leaf node merge's anchor set — recovers
    # seeds that majority-consensus collapse erases at high divergence
    # (src/progressiveMauve.cpp:575-710,643-646)
    translated_anchors: bool = True
    translated_anchor_pairs: int = 2  # cross-clade pairs consulted per node
    # rep-rep anchor coverage (sum of match lengths / mean rep length) below
    # which a node merge adds translated extant anchors; above it the merge
    # is already well-anchored and the extant searches are skipped (cost
    # control: an un-gated pass added ~36 s at 9 x 1 Mbp for accuracy the
    # well-anchored merges didn't need)
    translated_anchor_coverage: float = 0.5
    # profile-aware node-merge closure: gap placement scores TRUE clade
    # column profiles (mean-of-pairs over count profiles, device-normalized
    # uint8 counts) instead of the majority-consensus codes — the
    # reference's PSP-style profile alignment
    # (src/progressiveMauve.cpp:575-710).  Anchoring stays on consensus
    # codes (seeds need discrete symbols).  Measured accuracy-neutral on
    # the divergence sweep (BENCH_NOTES round 4: the tail is set by the
    # LCA rep-rep DP placement, which profile scoring barely moves) at a
    # 5x gap-upload cost, so default OFF; the option is the parity analog
    # of the reference's profile scoring.
    profile_closure: bool = False
    # member-aware LCA closure scoring (the divergence-tail fix, round-5):
    # at each node merge the gapped CLOSURE scores the codes of the CLOSEST
    # cross-clade extant member pair (lifted through the column maps,
    # consensus-backed where that member is absent) instead of the
    # majority-consensus reps.  Anchoring still sees the consensus reps
    # (divergence amplification), but gap/indel placement — which decides a
    # pair's columns at its LCA — follows true extant evidence, so the
    # 1-2 bp double-gap holes consensus mismatch noise creates around
    # indels resolve the way a direct extant alignment does.  Ref: per-node
    # profile alignment + cache-db, src/progressiveMauve.cpp:575-710,643-646.
    lca_member_scoring: bool = False
    # prune SHORT occupancy<=1 column runs from internal node profiles
    # (>= 3 members): private-insertion columns fragment the consensus rep
    # and distort later node DPs (models/tree_progressive.
    # _private_column_keep_mask); runs longer than tree_prune_max_run are
    # kept (clade-specific island ride-along).  Measured on the 9-way
    # 120 kbp sweeps: min pair sn 0.914 -> 0.964 at ~24% pairwise and
    # 0.953 -> 0.983 at ~16%, ppv up everywhere — the round-5
    # divergence-tail fix, default ON.
    tree_prune_private: bool = True
    tree_prune_max_run: int = 20
    # run the whole pipeline over a mesh (parallel.Mesh): the N-way anchor
    # search routes through parallel.find_multi_mums_sharded, and every
    # batched kernel underneath (node-merge anchoring, closure/refinement
    # Gotoh, backbone HMM decode) splits its batch via the ambient mesh
    # context (parallel/context.py).  Output is identical to single-device
    # (the reference's never-shipped MPI split,
    # projects/mpiMauveAligner.vcproj).  None = single device.
    mesh: Optional[object] = None
    # mer-space subsample (1/mod of windows) for the initial N-way search
    # when it only feeds distances + the coverage gate (tree-progressive
    # candidates); extension recovers full match lengths, so coverage and
    # distances stay accurate while the big sort shrinks ~mod-fold
    distance_sketch: int = 16
    # torch device of every device phase (anchoring, closure, refinement,
    # boundary extension, backbone HMM): "cuda" runs the CUDA kernels, "cpu"
    # the plain-torch versions.  No fallback: "cuda" without a GPU raises.
    device: str = "cuda"


def nway_coverage(ml, genomes) -> float:
    """The tree-progressive gate's reading: the summed length of the
    matches found in every genome over the mean genome length.  `ml` may
    be either package's MatchList."""
    return float(ml.multiplicity_filter(len(genomes)).lengths.sum()) / max(
        float(np.mean([len(g) for g in genomes])), 1.0)


@dataclasses.dataclass
class ProgressiveResult:
    interval_list: IntervalList
    lcbs: List[LCB]
    mums: MatchList
    guide_tree: TreeNode
    backbone_rows: np.ndarray  # [n_rows, 2*n_seqs] signed coordinate rows
    backbone_segments: List


class ProgressiveMauve:
    def __init__(self, options: Optional[ProgressiveOptions] = None):
        self.options = options or ProgressiveOptions()
        self.device = resolve_device(self.options.device)

    def _seed_rank(self) -> int:
        o = self.options
        if o.solid_seeds:
            from mauvealigner_tpu_torch.seeds import SOLID_SEED

            return SOLID_SEED
        return CODING_SEED if o.coding_seeds else 0

    def find_matches(
        self, genomes: Sequence[Genome], sketch_mod: int = 1
    ) -> MatchList:
        o = self.options
        avg = int(np.mean([len(g) for g in genomes]))
        weight = o.seed_weight or default_seed_weight(avg)
        self._seed_weight = weight
        if o.seed_family:
            # search with all three spaced family members, longest first
            # (src/progressiveMauve.cpp:504-548); results are merged+deduped
            ml: Optional[MatchList] = None
            for seed in seed_family(weight):
                smls_dev = [build_mer_list_device(g, seed, self.device) for g in genomes]
                cur = matchops.find_multi_mums_device(
                    genomes, smls_dev, seed_length=seed.length
                )
                ml = cur if ml is None else ml.concat(cur).dedup()
            return ml if ml is not None else MatchList.empty(len(genomes))
        seed = get_seed(weight, self._seed_rank())
        if o.use_sml_cache and any(g.filename for g in genomes):
            # disk-cache path: per-genome load-or-build, like the reference's
            # LoadSMLs (genomes without file names just build in memory)
            smls = [
                load_sml(g, seed, device=self.device) if g.filename
                else build_sml(g, seed, self.device)
                for g in genomes
            ]
            return matchops.find_multi_mums(genomes, smls, device=self.device)
        smls_dev = [build_mer_list_device(g, seed, self.device) for g in genomes]
        from mauvealigner_tpu_torch.parallel import context as par_ctx

        mesh = par_ctx.active_mesh()
        if mesh is not None and sketch_mod <= 1:
            # mesh path: the two-phase all-to-all partitioned N-way search
            # (the sketched candidate search stays single-device: a 1/16 mer
            # subsample is already cheap and shards poorly)
            from mauvealigner_tpu_torch.parallel import find_multi_mums_sharded

            return find_multi_mums_sharded(genomes, smls_dev, mesh, seed_length=seed.length)
        return matchops.find_multi_mums_device(
            genomes, smls_dev, seed_length=seed.length, sketch_mod=sketch_mod
        )

    def guide_tree(
        self, genomes: Sequence[Genome], ml: MatchList, dist: Optional[np.ndarray] = None
    ) -> TreeNode:
        o = self.options
        if o.input_guide_tree:
            with open(o.input_guide_tree) as fh:
                tree = parse_newick(fh.read())
            leaves = tree.leaves()
            if len(leaves) != len(genomes):
                raise ValueError(
                    f"guide tree has {len(leaves)} leaves for "
                    f"{len(genomes)} input genomes"
                )
            # leaf names bind to genome indices only when they are exactly
            # the 0-based set {0..n-1}; anything else (filenames, 1-based
            # labels from external tools) maps to input order — passing
            # digit labels through unchecked would silently bind clades to
            # the wrong genomes
            names = [leaf.name or "" for leaf in leaves]
            zero_based = all(n.isdigit() for n in names) and sorted(
                int(n) for n in names
            ) == list(range(len(genomes)))
            if not zero_based:
                for i, leaf in enumerate(leaves):
                    leaf.name = str(i)
            return tree
        if dist is None:
            dist = coverage_distance_matrix(ml, [len(g) for g in genomes])
        names = [str(i) for i in range(len(genomes))]
        if o.guide_tree_method == "nj":
            tree = neighbor_joining(dist, names)
        else:
            tree = upgma(dist, names)
        if o.output_guide_tree:
            with open(o.output_guide_tree, "w") as fh:
                fh.write(write_newick(tree) + "\n")
        return tree

    def _breakpoint_penalty(
        self, genomes: Sequence[Genome], unit_factor: float = 1.0
    ) -> float:
        """Minimum LCB weight (setBreakpointPenalty semantics).  unit_factor
        converts the Mauve length-unit rule into the active scoring scheme's
        units (expected diag score x combinatorial pair factor)."""
        o = self.options
        if o.collinear:
            return -1.0
        if o.breakpoint_penalty is not None:
            return o.breakpoint_penalty
        base = self._seed_weight * 3 * len(genomes) * (
            o.breakpoint_scale + o.conservation_scale
        )
        penalty = base * unit_factor
        if o.min_scaled_penalty is not None:
            penalty = max(penalty, o.min_scaled_penalty)
        return penalty

    def _anchor_scoring(self, genomes: Sequence[Genome], dist: np.ndarray):
        """(weight_fn, unit_factor) for the configured scoring scheme
        (AncestralScoring / AncestralSumOfPairsScoring /
        ExtantSumOfPairsScoring, src/progressiveMauve.cpp:611-625)."""
        from mauvealigner_tpu_torch.models import anchor_score

        o = self.options
        if o.scoring_scheme == "length":
            return None, 1.0
        n = len(genomes)
        scales = None
        if o.lcb_weight_scaling and o.scoring_scheme == "sp":
            scales = anchor_score.pair_scales(
                dist, o.breakpoint_scale, o.conservation_scale
            )
            pair_factor = float(np.triu(scales, 1).sum())
        elif o.scoring_scheme == "sp":
            pair_factor = n * (n - 1) / 2.0
        elif o.scoring_scheme == "ancestral":
            pair_factor = float(n)
        elif o.scoring_scheme == "sp_ancestral":
            pair_factor = float(n - 1)
        else:
            raise ValueError(f"unknown scoring scheme {o.scoring_scheme!r}")
        weight_fn = anchor_score.make_weight_fn(genomes, o.scoring_scheme, scales)
        unit_factor = anchor_score.expected_diag(genomes) * max(pair_factor, 1e-9)
        return weight_fn, unit_factor

    def align(
        self, genomes: Sequence[Genome], matches: Optional[MatchList] = None
    ) -> ProgressiveResult:
        """matches: pre-computed match list (--match-input phase re-entry,
        src/progressiveMauve.cpp:367-385); skips the anchor search."""
        from mauvealigner_tpu_torch.parallel import context as par_ctx

        with par_ctx.use_mesh(self.options.mesh):
            return self._align_impl(genomes, matches)

    def _align_impl(
        self, genomes: Sequence[Genome], matches: Optional[MatchList] = None
    ) -> ProgressiveResult:
        from mauvealigner_tpu_torch.utils import timing

        timer = timing.GLOBAL
        o = self.options
        if matches is not None:
            avg = int(np.mean([len(g) for g in genomes]))
            self._seed_weight = o.seed_weight or default_seed_weight(avg)
            ml = matches
            sketched = False
        else:
            # when the search can only feed distances + the coverage gate
            # (tree-progressive candidates), a mer-space sketch suffices —
            # but only at scale: below ~4 Mbases total the full search is
            # cheap and the subsample would add distance noise
            total_bases = int(sum(len(g) for g in genomes))
            sketched = (
                o.tree_progressive is not False
                and o.distance_sketch > 1
                and total_bases > 4_000_000
            )
            with timer.phase("anchoring"):
                ml = self.find_matches(
                    genomes, sketch_mod=o.distance_sketch if sketched else 1
                )
        with timer.phase("distance"):
            dist = coverage_distance_matrix(ml, [len(g) for g in genomes])
        with timer.phase("guide_tree"):
            tree = self.guide_tree(genomes, ml, dist)
        use_tree = o.tree_progressive
        if use_tree is None:
            use_tree = nway_coverage(ml, genomes) < o.tree_progressive_threshold
        if use_tree:
            return self._align_tree_progressive(genomes, ml, tree, timer, dist)
        if sketched:
            # the extant pipeline consumes the matches themselves: redo the
            # search at full density
            with timer.phase("anchoring"):
                ml = self.find_matches(genomes)
        weight_fn, unit_factor = self._anchor_scoring(genomes, dist)
        # LCB structure over full-multiplicity anchors (subset-LCB support is
        # recovered by the backbone application step)
        inner = MauveAligner(
            AlignerOptions(
                seed_size=self._seed_weight,
                lcb_weight=None
                if o.collinear
                else self._breakpoint_penalty(genomes, unit_factor),
                collinear=o.collinear,
                recursive=o.recursive,
                gapped=o.gapped,
                max_gapped_len=o.max_gapped_len,
                gap_open=o.gap_open,
                gap_extend=o.gap_extend,
                subst=o.subst,
                anchor_weight_fn=weight_fn,
                mesh=o.mesh,
                device=o.device,
            )
        )
        inner._seed_weight = self._seed_weight
        with timer.phase("lcb_determination"):
            nway = ml.multiplicity_filter(len(genomes))
            anchors, lcbs = inner.determine_lcbs(genomes, nway)
        if o.recursive:
            with timer.phase("recursive_anchoring"):
                anchors, lcbs = inner.recursive_anchor(genomes, anchors, lcbs)
        # closure ordered by the guide tree
        plan = closure.tree_plan(tree)
        with timer.phase("gapped_closure"):
            ivl = self._build_intervals_with_plan(inner, genomes, anchors, lcbs, plan)
        if o.boundary_extension and o.gapped:
            from mauvealigner_tpu_torch.models.boundary import extend_interval_boundaries

            # before the subset pass: a full-multiplicity LCB edge extends at
            # full arity; clade-restricted subset recovery then works over
            # whatever remains unclaimed.
            # NOTE: full-length-alignment semantics — non-homologous flank
            # columns produced here are stripped later by the backbone HMM
            # (apply_backbone un-aligns them).  Under --disable-backbone they
            # stay aligned, exactly as the reference emits its full gapped
            # closure when applyBackbone is skipped
            # (src/progressiveMauve.cpp:712-719).
            with timer.phase("boundary_extension"):
                ivl = extend_interval_boundaries(
                    ivl,
                    genomes,
                    plan,
                    subst=o.subst,
                    gap_open=o.gap_open,
                    gap_extend=o.gap_extend,
                    max_flank=o.max_extension_flank,
                    device=self.device,
                )
        if o.subset_lcbs and len(genomes) > 2:
            # clade-restricted anchoring over still-unaligned regions: the
            # translated-anchor analog recovering subset LCBs
            from mauvealigner_tpu_torch.models.subset import subset_lcb_pass
            from mauvealigner_tpu_torch.seeds import get_seed

            seed = get_seed(max(self._seed_weight - 2, 5), 0)

            def _close(kept, sub_lcbs):
                return inner.build_intervals(genomes, kept, sub_lcbs).intervals

            with timer.phase("subset_lcbs"):
                ivl, n_subset = subset_lcb_pass(
                    genomes, ivl, tree, seed, closure_fn=_close, device=self.device
                )
        if o.refine and o.gapped:
            from mauvealigner_tpu_torch.models.refine import refine_intervals

            with timer.phase("refinement"):
                ivl, _ = refine_intervals(
                    ivl, plan, gap_open=o.gap_open, gap_extend=o.gap_extend,
                    mode=o.refine_mode, subst=o.subst, device=self.device,
                )
        with timer.phase("unaligned"):
            ivl.add_unaligned_intervals()

        backbone_rows = np.zeros((0, 2 * len(genomes)), np.int64)
        segments: List = []
        if not o.skip_backbone and len(genomes) >= 2:
            with timer.phase("homology_backbone"):
                gc = bb.compute_gc(genomes)
                params = bb.adapted_params(
                    gc,
                    identity=o.hmm_identity,
                    go_homologous=o.hmm_p_go_homologous,
                    go_unrelated=o.hmm_p_go_unrelated,
                )
                segments = bb.detect_backbone(
                    ivl, params, o.island_gap_size, device=self.device
                )
                with timer.phase("bb_rows"):
                    raw = bb.backbone_seq_coordinates(ivl, segments, as_matrix=True)
                    rows = bb.merge_coordinate_rows(raw)
                    rows = bb.add_unique_segments(rows, ivl, [len(g) for g in genomes])
                    backbone_rows = rows
                ivl = bb.apply_backbone(ivl, segments, raw_coords=raw)
        return ProgressiveResult(ivl, lcbs, ml, tree, backbone_rows, segments)

    def _translated_anchor_fn(self, genomes, dist):
        """Profile-aware anchoring for the divergence tail: per node merge,
        find unique MUMs between the CLOSEST cross-clade EXTANT pair and
        lift them through the children's column maps into rep space
        (models/tree_progressive.translate_extant_matches).  Extant seeds
        see the true sequences, so node-level anchors survive what majority
        -consensus collapse erases (ref: per-node profile anchoring + match
        cache-db, src/progressiveMauve.cpp:575-710,643-646)."""
        from mauvealigner_tpu_torch.models import tree_progressive as tp
        from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed

        cache: dict = {}
        k_pairs = self.options.translated_anchor_pairs

        def search(am, bm):
            if (am, bm) not in cache:
                w = default_mer_size(
                    int(np.mean([len(genomes[am]), len(genomes[bm])]))
                )
                seed = get_seed(w, 0)
                smls = [
                    build_mer_list_device(genomes[g], seed, self.device)
                    for g in (am, bm)
                ]
                cache[(am, bm)] = matchops.find_multi_mums_device(
                    [genomes[am], genomes[bm]], smls, seed_length=seed.length
                )
            return cache[(am, bm)]

        cov_thr = self.options.translated_anchor_coverage

        def fn(a, b, found_ml=None):
            if len(a.members) == 1 and len(b.members) == 1:
                return None  # a leaf-leaf merge IS an extant pairwise search
            if found_ml is not None:
                # engage only where rep-rep anchoring is WEAK: when found
                # anchors already cover the reps, consensus collapse isn't
                # hurting this merge and the extant searches are pure cost
                cov = float(found_ml.lengths.sum()) / max(
                    float(np.mean([len(a.rep), len(b.rep)])), 1.0
                )
                if cov >= cov_thr:
                    return None
            ranked = sorted(
                (float(dist[x, y]), x, y)
                for x in a.members
                for y in b.members
            )
            # top-K closest cross-clade pairs, preferring unseen members so
            # anchors cover content any single member may have lost
            chosen, seen = [], set()
            for d, x, y in ranked:
                if len(chosen) >= k_pairs:
                    break
                if chosen and x in seen and y in seen:
                    continue
                chosen.append((x, y))
                seen.update((x, y))
            inv_cache: dict = {}

            def inv(prof, m):
                if m not in inv_cache:
                    inv_cache[m] = tp.inverse_colmap(
                        prof.colmaps[m], len(genomes[m])
                    )
                return inv_cache[m]

            out = None
            for am, bm in chosen:
                got = tp.translate_extant_matches(
                    search(am, bm), inv(a, am), inv(b, bm)
                )
                out = got if out is None else out.concat(got)
            return out.dedup() if out is not None else None

        return fn

    def _member_scoring_fn(self, genomes, dist):
        """Member-aware LCA closure scoring (lca_member_scoring): per node
        merge, the gapped closure scores the CLOSEST cross-clade extant
        pair's codes lifted through the column maps (consensus-backed where
        that member is absent) instead of the consensus reps.

        Mechanism (round-4 tail anatomy, BENCH_NOTES): a pair's columns are
        decided at its LCA's rep-rep DP; consensus mismatch noise around
        indels flips DIAGs into double-gaps (match +91 vs 2x gap-extend
        -60), leaving 1-2 bp UNALIGNED holes a direct extant alignment does
        not have.  Scoring the closest extant pair restores those DIAGs
        while anchoring keeps the consensus divergence amplification.
        Ref: src/progressiveMauve.cpp:575-710 (profile alignment up the
        guide tree)."""
        from mauvealigner_tpu_torch.models import tree_progressive as tp

        def backed(prof, m):
            bases = tp._member_bases(genomes, prof.colmaps[m], m)
            rep = prof.rep.codes
            out = np.where(bases < 4, bases, np.minimum(rep, 4)).astype(
                np.int64
            )
            return Genome.from_codes(out, name=f"score_{m}")

        def fn(a, b):
            if len(a.members) == 1 and len(b.members) == 1:
                return None  # leaf-leaf closure already scores extant codes
            best = min(
                (float(dist[x, y]), x, y)
                for x in a.members
                for y in b.members
            )
            _, ma, mb = best
            return backed(a, ma), backed(b, mb)

        return fn

    def _align_tree_progressive(
        self, genomes, ml, tree, timer, dist=None
    ) -> "ProgressiveResult":
        """Consensus-ladder pipeline: per-node pairwise alignment up the
        guide tree, then refinement and the homology backbone."""
        from mauvealigner_tpu_torch.models import closure as closure_mod
        from mauvealigner_tpu_torch.models.tree_progressive import tree_progressive_align

        o = self.options

        def factory():
            # honor the user's anchoring/scoring knobs at every node merge;
            # an explicit --weight is in pairwise-length units here (each
            # node merge is a single consensus pair), and sp weight_fn does
            # not apply (sum-of-pairs over 2 rows IS match length)
            inner = MauveAligner(
                AlignerOptions(
                    seed_size=o.seed_weight,
                    lcb_weight=o.breakpoint_penalty,
                    collinear=o.collinear,
                    recursive=o.recursive,
                    gapped=o.gapped,
                    max_gapped_len=o.max_gapped_len,
                    gap_open=o.gap_open,
                    gap_extend=o.gap_extend,
                    subst=o.subst,
                    mesh=o.mesh,  # explicit: a node merge need not run
                    # where the ambient mesh is set
                    device=o.device,
                )
            )
            return inner

        translated = (
            self._translated_anchor_fn(genomes, dist)
            if o.translated_anchors and dist is not None
            else None
        )
        scoring = (
            self._member_scoring_fn(genomes, dist)
            if o.lca_member_scoring and dist is not None
            else None
        )
        with timer.phase("tree_progressive"):
            ivl, lcbs = tree_progressive_align(
                genomes, tree, factory, translated_fn=translated,
                profile_closure=o.profile_closure, scoring_fn=scoring,
                prune_private=o.tree_prune_private,
                prune_private_max_run=o.tree_prune_max_run,
            )
        plan = closure_mod.tree_plan(tree)
        if o.refine and o.gapped:
            from mauvealigner_tpu_torch.models.refine import refine_intervals

            with timer.phase("refinement"):
                ivl, _ = refine_intervals(
                    ivl, plan, gap_open=o.gap_open, gap_extend=o.gap_extend,
                    mode=o.refine_mode, subst=o.subst, device=self.device,
                )
        with timer.phase("unaligned"):
            ivl.add_unaligned_intervals()
        backbone_rows = np.zeros((0, 2 * len(genomes)), np.int64)
        segments: List = []
        if not o.skip_backbone and len(genomes) >= 2:
            with timer.phase("homology_backbone"):
                gc = bb.compute_gc(genomes)
                params = bb.adapted_params(
                    gc,
                    identity=o.hmm_identity,
                    go_homologous=o.hmm_p_go_homologous,
                    go_unrelated=o.hmm_p_go_unrelated,
                )
                segments = bb.detect_backbone(
                    ivl, params, o.island_gap_size, device=self.device
                )
                with timer.phase("bb_rows"):
                    raw = bb.backbone_seq_coordinates(ivl, segments, as_matrix=True)
                    rows = bb.merge_coordinate_rows(raw)
                    rows = bb.add_unique_segments(rows, ivl, [len(g) for g in genomes])
                    backbone_rows = rows
                ivl = bb.apply_backbone(ivl, segments, raw_coords=raw)
        return ProgressiveResult(ivl, lcbs, ml, tree, backbone_rows, segments)

    def _build_intervals_with_plan(self, inner, genomes, ml, lcbs, plan) -> IntervalList:
        """build_intervals with a guide-tree merge plan for the closure."""
        o = self.options
        n = len(genomes)
        gap_groups, gap_ref, per_lcb = [], [], []
        for li, lcb in enumerate(lcbs):
            sub = inner.make_collinear_nonoverlapping(ml.select(lcb.match_indices))
            per_lcb.append(sub)
            if len(sub) < 2:
                continue
            left, right, strand = inner._gap_region_table(sub)
            for a in range(len(sub) - 1):
                regions = [
                    inner._extract_region(
                        genomes[g], int(left[a, g]), int(right[a, g]), int(strand[a, g])
                    )
                    for g in range(n)
                ]
                gap_groups.append(regions)
                gap_ref.append((li, a))
        if o.gapped and gap_groups:
            gap_alns = closure.hierarchical_align_region_groups(
                gap_groups,
                plan,
                subst=o.subst if o.subst is not None else dp.HOXD70,
                gap_open=o.gap_open,
                gap_extend=o.gap_extend,
                max_len=o.max_gapped_len,
                device=self.device,
            )
        else:
            gap_alns = [closure._unaligned_blocks(g) for g in gap_groups]
        gap_table = dict(zip(gap_ref, gap_alns))
        from mauvealigner_tpu_torch.models.aligner import assemble_lcb_intervals

        intervals = assemble_lcb_intervals(per_lcb, gap_table, n)
        return IntervalList(genomes=list(genomes), intervals=intervals)

    def write_outputs(self, result: ProgressiveResult, output_prefix: str) -> None:
        """XMFA + .backbone + .bbcols (src/progressiveMauve.cpp:245-259,722)."""
        bb_name = output_prefix + ".backbone"
        cols_name = output_prefix + ".bbcols"
        if len(result.backbone_rows):
            bb.write_backbone_seq_file(
                result.backbone_rows, bb_name, result.interval_list.n_seqs
            )
            bb.write_backbone_cols_file(result.backbone_segments, cols_name)
            result.interval_list.backbone_filename = cols_name
        result.interval_list.write_xmfa(output_prefix)
