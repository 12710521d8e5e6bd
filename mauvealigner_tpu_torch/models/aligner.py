"""MauveAligner: the original Mauve algorithm, in PyTorch (port of
mauvealigner_tpu/models/aligner.py).

Pipeline parity with Aligner::align + doAlignment
(src/mauveAligner.cpp:70,668-744):

  1. unique multi-MUM anchors (K1 sort + K2 enumeration on device);
  2. overlap elimination + n-way filter;
  3. LCB determination via greedy breakpoint elimination
     (weight threshold default seed_weight*3*seq_count,
      src/mauveAligner.cpp:648-656; collinear mode -> single LCB,
      src/mauveAligner.cpp:664-666);
  4. recursive anchoring inside inter-anchor gaps with lighter seeds
     (min gap 200, src/mauveAligner.cpp:899);
  5. gapped closure of the remaining gaps via batched profile DP
     (replaces the MUSCLE subprocess);
  6. Interval assembly per LCB -> IntervalList (XMFA-ready).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList
from mauvealigner_tpu_torch.core.sml import build_mer_list_device
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.models.lcb import LCB, greedy_breakpoint_elimination
from mauvealigner_tpu_torch.ops import dp, matchops
from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed


@dataclasses.dataclass
class AlignerOptions:
    seed_size: int = 0            # 0 = default log2(avg len)
    seed_rank: int = 0
    lcb_weight: Optional[int] = None  # None = seed_weight*3*n_seqs
    collinear: bool = False
    recursive: bool = True
    min_recursion_gap: int = 200      # src/mauveAligner.cpp:899
    max_recursion_rounds: int = 3
    lcb_extension: bool = True
    max_extension_iters: int = 4      # SetMaxExtensionIterations, src/mauveAligner.cpp:879
    gapped: bool = True
    max_gapped_len: int = 4096        # --max-gapped-aligner-length analog
    eliminate_overlaps: bool = True
    nway_filter: bool = True
    gap_open: float = dp.DEFAULT_GAP_OPEN
    gap_extend: float = dp.DEFAULT_GAP_EXTEND
    subst: Optional[np.ndarray] = None  # 5x5 substitution scores; None = HOXD70
    use_sml_cache: bool = True
    debug: bool = False  # internal consistency checks (--debug, very slow)
    # run the N-way anchor search over a mesh (parallel.Mesh: the two-phase
    # all-to-all partitioned search, parallel.find_multi_mums_sharded), and
    # split every batched kernel underneath over it; None = single device.
    # Output matches the single-device run.
    mesh: Optional[object] = None
    # optional anchor scoring callback MatchList -> [n] float weights
    # (progressive sum-of-pairs schemes, models/anchor_score.py); lcb_weight
    # must then be in the same units
    anchor_weight_fn: Optional[object] = None
    # alternate genomes (same coordinates/lengths as the inputs) whose codes
    # the GAPPED CLOSURE scores instead of the inputs' — the progressive
    # ladder's member-aware LCA scoring (closest cross-clade extant pair
    # backed by consensus; ref: per-node profile alignment,
    # src/progressiveMauve.cpp:575-710).  Anchoring/recursion/extension
    # still see the input genomes.
    closure_genomes: Optional[List] = None
    # torch device of every device phase: "cuda" runs the CUDA kernels,
    # "cpu" the plain-torch versions of the same code.  No fallback: "cuda"
    # without a visible GPU raises.
    device: str = "cuda"


def assemble_lcb_intervals(
    per_lcb_matches: List[MatchList],
    gap_table: dict,
    n: int,
) -> List[Interval]:
    """Interleave anchor blocks and gap alignments into per-LCB Intervals.

    gap_table[(li, a)] is the [n, w] boolean gap alignment between anchors
    a and a+1 of LCB li.  Anchor presence fills VECTORIZED per genome with
    a range-difference array (the per-anchor block-alloc + 17k-piece
    np.concatenate this replaces owned the closure phase's host time at
    genome scale); gap blocks copy in directly."""
    intervals: List[Interval] = []
    for li, sub in enumerate(per_lcb_matches):
        m = len(sub)
        if m == 0:
            continue
        anchor_w = sub.lengths.astype(np.int64)
        gap_w = np.array(
            [gap_table[(li, a)].shape[1] for a in range(m - 1)] + [0],
            np.int64,
        )
        # column offset of anchor a = sum of preceding anchor + gap widths
        anchor_c0 = np.zeros(m, np.int64)
        if m > 1:
            anchor_c0[1:] = np.cumsum(anchor_w[:-1] + gap_w[:-1])
        total = int(anchor_c0[-1] + anchor_w[-1])
        aln_full = np.zeros((n, total), bool)
        pres = sub.starts != NO_MATCH  # [m, n]
        delta = np.zeros(total + 1, np.int8)
        for g in range(n):
            sel = pres[:, g]
            if not sel.any():
                continue
            delta[:] = 0
            s = anchor_c0[sel]
            # starts and ends are each unique; a slot shared by anchor a's
            # end and anchor a+1's start (empty gap) nets 0 after the
            # subtraction, which cumsum reads as a seamless continuation
            delta[s] = 1
            delta[s + anchor_w[sel]] -= 1
            aln_full[g] = np.cumsum(delta[:-1]) > 0
        for a in range(m - 1):
            ga = gap_table[(li, a)]
            w = ga.shape[1]
            if w:
                c0 = int(anchor_c0[a] + anchor_w[a])
                aln_full[:, c0 : c0 + w] = ga
        starts = np.zeros(n, np.int64)
        for g in range(n):
            comps = sub.starts[:, g]
            present = comps != NO_MATCH
            if not present.any():
                continue
            strand = 1 if comps[present][0] > 0 else -1
            starts[g] = strand * int(np.abs(comps[present]).min())
        intervals.append(Interval(starts, aln_full))
    return intervals


@dataclasses.dataclass
class AlignmentResult:
    interval_list: IntervalList
    lcbs: List[LCB]
    mums: MatchList


def resolve_device(device) -> torch.device:
    """torch.device of AlignerOptions.device; raises when it names CUDA and
    torch sees no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device "
            "(pass device='cpu' for the plain-torch path)"
        )
    return dev


class MauveAligner:
    def __init__(self, options: Optional[AlignerOptions] = None):
        self.options = options or AlignerOptions()
        self.device = resolve_device(self.options.device)

    # -- phase 1: anchoring -------------------------------------------------
    def find_mums(self, genomes: Sequence[Genome]) -> MatchList:
        o = self.options
        avg = int(np.mean([len(g) for g in genomes]))
        weight = o.seed_size or default_mer_size(avg)
        seed = get_seed(weight, o.seed_rank)
        self._seed_weight = weight
        smls_dev = [build_mer_list_device(g, seed, self.device) for g in genomes]
        from mauvealigner_tpu_torch.parallel import context as par_ctx

        mesh = o.mesh if o.mesh is not None else par_ctx.active_mesh()
        if mesh is not None:
            from mauvealigner_tpu_torch.parallel import find_multi_mums_sharded

            return find_multi_mums_sharded(genomes, smls_dev, mesh, seed_length=seed.length)
        return matchops.find_multi_mums_device(
            genomes, smls_dev, seed_length=seed.length
        )

    # -- phase 3: LCBs ------------------------------------------------------
    def determine_lcbs(
        self, genomes: Sequence[Genome], ml: MatchList
    ) -> Tuple[MatchList, List[LCB]]:
        o = self.options
        if o.nway_filter:
            ml = ml.multiplicity_filter(len(genomes))
        if o.eliminate_overlaps:
            ml = ml.eliminate_overlaps()
            if o.nway_filter:  # overlap crops can zero components
                ml = ml.multiplicity_filter(len(genomes))
            else:
                # overlap crops can reduce a row to one surviving component;
                # the reference's projection semantics drop multiplicity<2
                # rows, and a single-genome row is meaningless as an anchor
                ml = ml.multiplicity_filter(2)
        return greedy_breakpoint_elimination(
            ml, self._lcb_weight(len(genomes)), o.anchor_weight_fn
        )

    def _lcb_weight(self, n: int) -> float:
        """The LCB elimination threshold every phase shares: -1 in collinear
        mode, the user's --weight when given (0 is a valid 'never eliminate'
        value — test is None, not falsiness), else seed_weight * 3 * n."""
        o = self.options
        if o.collinear:
            return -1.0
        if o.lcb_weight is not None:
            return float(o.lcb_weight)
        return float(getattr(self, "_seed_weight", 15) * 3 * n)

    # -- phase 4: recursive anchoring ---------------------------------------
    @staticmethod
    def _gap_region_table(sub: MatchList):
        """Vectorized gap-region specs for every consecutive anchor pair of
        an LCB: (left, right, strand) int64 arrays [m-1, n_seqs]; left>right
        means empty, strand 0 means an absent component."""
        sa, sb = sub.starts[:-1], sub.starts[1:]
        la = sub.lengths[:-1, None]
        lb = sub.lengths[1:, None]
        fwd = sa > 0
        left = np.where(fwd, np.abs(sa) + la, np.abs(sb) + lb)
        right = np.where(fwd, np.abs(sb) - 1, np.abs(sa) - 1)
        strand = np.where(fwd, 1, -1)
        absent = (sa == NO_MATCH) | (sb == NO_MATCH)
        left[absent], right[absent], strand[absent] = 1, 0, 0
        return left, right, strand

    def _extract_region(self, genome: Genome, left: int, right: int, strand: int) -> np.ndarray:
        if right < left:
            return np.zeros(0, np.int64)
        length = right - left + 1
        # forward regions stay VIEWS of the genome's code array (every
        # consumer converts while staging); the astype copy here cost ~8 s
        # of pure allocation per headline run across ~1M gap extractions
        return genome.sub_codes_signed(strand * left, length)

    def recursive_anchor(
        self, genomes: Sequence[Genome], ml: MatchList, lcbs: List[LCB]
    ) -> Tuple[MatchList, List[LCB]]:
        """Search inter-anchor gaps with lighter seeds and fold new anchors in
        (recursion phase, SetMinRecursionGapLength default 200).

        All gaps of a round are searched in ONE device pass per seed weight
        (matchops.find_gap_mums_batched): thousands of gaps qualify on
        real-scale inputs, and per-gap searches would each pay the launch
        and synchronization overhead.
        """
        o = self.options
        n = len(genomes)
        for _ in range(o.max_recursion_rounds):
            # collect qualifying gap specs across all LCBs, grouped by the
            # per-gap seed weight (the reference picks a lighter seed from
            # the gap's average length)
            specs_by_w: dict = {}
            for lcb in lcbs:
                sub = ml.select(lcb.match_indices)
                if len(sub) < 2:
                    continue
                left_t, right_t, strand_t = self._gap_region_table(sub)
                lens_t = np.maximum(0, right_t - left_t + 1)
                qual = (lens_t.max(axis=1) >= o.min_recursion_gap) & (
                    lens_t.min(axis=1) > 0
                )
                if not qual.any():
                    continue
                avg = np.maximum(lens_t[qual].mean(axis=1), 4.0)
                base_w = getattr(self, "_seed_weight", 15) - 2
                for a, av in zip(np.nonzero(qual)[0], avg):
                    w = max(5, min(default_mer_size(float(av)), base_w))
                    specs_by_w.setdefault(w, []).append(
                        np.stack([left_t[a], right_t[a], strand_t[a]], axis=1)
                    )
            new_rows = []
            for w, spec_list in sorted(specs_by_w.items()):
                seed = get_seed(w, 0)
                gap_specs = np.stack(spec_list)  # [G, n, 3]
                # every region must fit at least one seed window
                lens = gap_specs[:, :, 1] - gap_specs[:, :, 0] + 1
                gap_specs = gap_specs[(lens >= seed.length).all(axis=1)]
                if not len(gap_specs):
                    continue
                gap_ids, found = matchops.find_gap_mums_batched(
                    genomes, gap_specs, seed, self.device
                )
                full = found.multiplicity() >= n
                gap_ids, found = gap_ids[full], found.select(full)
                # keep the best collinear chain within each gap
                import time as _time

                from mauvealigner_tpu_torch.utils import timing as _timing

                _t0 = _time.perf_counter()
                for g in np.unique(gap_ids):
                    sub_ml = found.select(gap_ids == g)
                    sub_ml, _ = greedy_breakpoint_elimination(sub_ml, -1)
                    if len(sub_ml):
                        new_rows.append(sub_ml)
                _timing.GLOBAL.add(
                    "recursion_chain_s", _time.perf_counter() - _t0
                )
            if not new_rows:
                break
            add = new_rows[0]
            for extra in new_rows[1:]:
                add = add.concat(extra)
            merged = ml.concat(add).dedup()
            if len(merged) == len(ml):
                # every gap MUM was a re-find of an existing row: ml/lcbs
                # from the previous round stay valid, and further rounds
                # would re-run identical device programs for nothing
                break
            ml = merged
            ml, lcbs = greedy_breakpoint_elimination(
                ml, self._lcb_weight(n), o.anchor_weight_fn
            )
        return ml, lcbs

    # -- phase 4b: LCB extension --------------------------------------------
    def extend_lcbs(
        self, genomes: Sequence[Genome], ml: MatchList, lcbs: List[LCB]
    ) -> Tuple[MatchList, List[LCB]]:
        """Extend LCB coverage into the unanchored inter-LCB regions
        (<= max_extension_iters passes, src/mauveAligner.cpp:879): uncovered
        regions are re-anchored with a lighter seed; new anchors merge into
        (or extend) LCBs through re-elimination."""
        from mauvealigner_tpu_torch.models.subset import _build_subgenome, _map_back

        o = self.options
        n = len(genomes)
        weight = self._lcb_weight(n)
        seed = get_seed(max(5, getattr(self, "_seed_weight", 15) - 2), 0)
        for _ in range(o.max_extension_iters):
            # per-genome uncovered regions (outside every LCB extent)
            subs, offs = [], []
            any_work = False
            for g in range(n):
                glen = len(genomes[g])
                covered = np.zeros(glen + 2, bool)
                for lcb in lcbs:
                    if lcb.lefts[g]:
                        covered[lcb.lefts[g] : lcb.rights[g] + 1] = True
                free = ~covered[1 : glen + 1]
                d = np.diff(np.concatenate([[0], free.view(np.int8), [0]]))
                starts_ = np.nonzero(d == 1)[0] + 1
                ends_ = np.nonzero(d == -1)[0]
                regions = [
                    (int(a), int(b))
                    for a, b in zip(starts_, ends_)
                    if b - a + 1 >= seed.length
                ]
                sub, off = _build_subgenome(genomes[g], regions)
                subs.append(sub)
                offs.append(off)
                if regions:
                    any_work = True
            if not any_work:
                break
            live = [g for g in range(n) if len(subs[g])]
            if len(live) < 2:
                break
            smls = [build_mer_list_device(subs[g], seed, self.device) for g in live]
            found = matchops.find_multi_mums_device(
                [subs[g] for g in live], smls, seed_length=seed.length
            )
            if len(found) == 0:
                break
            rows = np.zeros((len(found), n), np.int64)
            for col, g in enumerate(live):
                rows[:, g] = _map_back(found.starts[:, col], found.lengths, offs[g])
            ok = (rows != 0).sum(axis=1) >= 2
            if o.nway_filter:
                ok = (rows != 0).all(axis=1)
            if not ok.any():
                break
            new_ml = MatchList(rows[ok], found.lengths[ok])
            ml2 = ml.concat(new_ml).dedup()
            if o.eliminate_overlaps:
                ml2 = ml2.eliminate_overlaps()
            if o.nway_filter:
                ml2 = ml2.multiplicity_filter(n)
            # re-eliminate BEFORE deciding convergence: breaking with stale
            # lcbs would leave match_indices pointing into a different row
            # layout than the returned list (both sides of the comparison
            # are greedy-elimination outputs, so row order is canonical)
            ml2, lcbs2 = greedy_breakpoint_elimination(
                ml2, weight, o.anchor_weight_fn
            )
            same = (
                len(ml2) == len(ml)
                and np.array_equal(ml2.starts, ml.starts)
                and np.array_equal(ml2.lengths, ml.lengths)
            )
            ml, lcbs = ml2, lcbs2
            if same:
                break
        return ml, lcbs

    # -- phase 5+6: gapped closure and interval assembly --------------------
    @staticmethod
    def make_collinear_nonoverlapping(sub: MatchList) -> MatchList:
        """Crop consecutive anchors of one LCB so no pair overlaps in any
        sequence (residual overlaps would break the interval tiling
        invariant).  Anchors cropped to nothing are dropped."""
        from mauvealigner_tpu_torch.core.match import _crop_row_left

        if len(sub) < 2:
            return sub
        sub = MatchList(sub.starts.copy(), sub.lengths.copy())
        prev = 0
        for a in range(1, len(sub)):
            if sub.lengths[prev] <= 0:
                prev = a
                continue
            max_overlap = 0
            for g in range(sub.n_seqs):
                sp, sc = int(sub.starts[prev, g]), int(sub.starts[a, g])
                if sp == 0 or sc == 0:
                    continue
                lp, lc = abs(sp), abs(sc)
                if sp > 0:
                    gap = lc - (lp + int(sub.lengths[prev]))
                else:
                    gap = lp - (lc + int(sub.lengths[a]))
                if gap < 0:
                    max_overlap = max(max_overlap, -gap)
            if max_overlap > 0:
                amt = min(max_overlap, int(sub.lengths[a]))
                _crop_row_left(sub, a, amt)
            if sub.lengths[a] > 0:
                prev = a
        keep = sub.lengths > 0
        return sub.select(keep)

    def build_intervals(
        self,
        genomes: Sequence[Genome],
        ml: MatchList,
        lcbs: List[LCB],
        seq_profiles: Optional[List[np.ndarray]] = None,
    ) -> IntervalList:
        import time as _time

        from mauvealigner_tpu_torch.utils import timing as _timing

        o = self.options
        n = len(genomes)
        if seq_profiles is not None and n == 2 and o.gapped:
            return self._build_intervals_profiles(
                genomes, ml, lcbs, seq_profiles
            )
        _t = _time.perf_counter()
        # closure scoring source: the inputs, or the member-aware stand-ins
        closure_src = o.closure_genomes or genomes
        # collect all gap groups over all LCBs for one batched closure pass
        gap_groups: List[List[np.ndarray]] = []
        gap_ref: List[Tuple[int, int]] = []  # (lcb index, position between a,a+1)
        per_lcb_matches: List[MatchList] = []
        for li, lcb in enumerate(lcbs):
            sub = self.make_collinear_nonoverlapping(ml.select(lcb.match_indices))
            per_lcb_matches.append(sub)
            if len(sub) < 2:
                continue
            left, right, strand = self._gap_region_table(sub)
            for a in range(len(sub) - 1):
                regions = [
                    self._extract_region(
                        closure_src[g], int(left[a, g]), int(right[a, g]), int(strand[a, g])
                    )
                    for g in range(n)
                ]
                gap_groups.append(regions)
                gap_ref.append((li, a))
        _timing.GLOBAL.add("cl_regions_s", _time.perf_counter() - _t)
        if o.gapped and gap_groups:
            gap_alns = closure.align_region_groups(
                gap_groups,
                subst=o.subst if o.subst is not None else dp.HOXD70,
                gap_open=o.gap_open,
                gap_extend=o.gap_extend,
                max_len=o.max_gapped_len,
                device=self.device,
            )
        else:
            gap_alns = [closure._unaligned_blocks(g) for g in gap_groups]
        gap_table = {ref: aln for ref, aln in zip(gap_ref, gap_alns)}

        _t = _time.perf_counter()
        intervals = assemble_lcb_intervals(per_lcb_matches, gap_table, n)
        _timing.GLOBAL.add("cl_assemble_s", _time.perf_counter() - _t)
        return IntervalList(genomes=list(genomes), intervals=intervals)

    @staticmethod
    def _extract_profile(
        prof: np.ndarray, left: int, right: int, strand: int
    ) -> np.ndarray:
        """Signed-region slice of a [L, 5] count profile: reverse-strand
        regions reverse the rows and complement the base lanes (A<->T,
        C<->G; the ambiguity lane stays)."""
        if right < left:
            return np.zeros((0, 5), prof.dtype)
        chunk = prof[left - 1 : right]
        if strand >= 0:
            return chunk
        return chunk[::-1, [3, 2, 1, 0, 4]]

    def _build_intervals_profiles(
        self,
        genomes: Sequence[Genome],
        ml: MatchList,
        lcbs: List[LCB],
        seq_profiles: List[np.ndarray],
    ) -> IntervalList:
        """Pairwise build_intervals whose gapped closure aligns TRUE column
        count profiles with mean-of-pairs scoring (the reference's
        PSP-style profile alignment, src/progressiveMauve.cpp:575-710) —
        majority-consensus codes still drive anchoring, but gap placement
        sees the full clade composition."""
        import time as _time

        from mauvealigner_tpu_torch.utils import timing as _timing

        o = self.options
        n = 2
        _t = _time.perf_counter()
        prof_pairs = []   # (profA, lenA, profB, lenB)
        pair_ref: List[Tuple[int, int]] = []
        gap_table: dict = {}
        per_lcb_matches: List[MatchList] = []
        for li, lcb in enumerate(lcbs):
            sub = self.make_collinear_nonoverlapping(ml.select(lcb.match_indices))
            per_lcb_matches.append(sub)
            if len(sub) < 2:
                continue
            left, right, strand = self._gap_region_table(sub)
            for a in range(len(sub) - 1):
                regs = [
                    self._extract_profile(
                        seq_profiles[g], int(left[a, g]), int(right[a, g]),
                        int(strand[a, g]),
                    )
                    for g in range(n)
                ]
                la, lb = len(regs[0]), len(regs[1])
                if la == 0 and lb == 0:
                    gap_table[(li, a)] = np.zeros((n, 0), bool)
                elif la == 0 or lb == 0 or max(la, lb) > o.max_gapped_len:
                    # degenerate or over the cap: unaligned block emission
                    aln = np.zeros((n, la + lb), bool)
                    aln[0, :la] = True
                    aln[1, la:] = True
                    gap_table[(li, a)] = aln
                else:
                    prof_pairs.append((regs[0], la, regs[1], lb))
                    pair_ref.append((li, a))
        _timing.GLOBAL.add("cl_regions_s", _time.perf_counter() - _t)
        if prof_pairs:
            ops_list = closure._batched_profile_pair_align(
                prof_pairs,
                o.subst if o.subst is not None else dp.HOXD70,
                o.gap_open,
                o.gap_extend,
                self.device,
                normalize=True,
            )
            for (li, a), ops in zip(pair_ref, ops_list):
                ra, rb = dp.ops_to_gap_rows(ops)
                gap_table[(li, a)] = np.stack([ra, rb])
        _t = _time.perf_counter()
        intervals = assemble_lcb_intervals(per_lcb_matches, gap_table, n)
        _timing.GLOBAL.add("cl_assemble_s", _time.perf_counter() - _t)
        return IntervalList(genomes=list(genomes), intervals=intervals)

    # -- full pipeline ------------------------------------------------------
    def align(
        self,
        genomes: Sequence[Genome],
        extra_matches: Optional[MatchList] = None,
        seq_profiles: Optional[List[np.ndarray]] = None,
    ) -> AlignmentResult:
        """extra_matches: additional anchors unioned with the MUM search
        result before LCB determination (the progressive aligner's
        translated extant anchors, models/tree_progressive.py).

        seq_profiles: per-input uint8 [len, 5] column count profiles; when
        given (pairwise only), the gapped closure aligns TRUE column
        profiles (mean-of-pairs scoring) instead of the sequences' codes —
        the progressive ladder's profile-aware node merge."""
        from mauvealigner_tpu_torch.parallel import context as par_ctx

        # ambient mesh: every batched kernel below (closure/extension DP)
        # splits its batch over it; the anchor search routes explicitly
        # through find_multi_mums_sharded in find_mums
        with par_ctx.use_mesh(self.options.mesh):
            return self._align_impl(genomes, extra_matches, seq_profiles)

    def _align_impl(
        self,
        genomes: Sequence[Genome],
        extra_matches: Optional[MatchList] = None,
        seq_profiles: Optional[List[np.ndarray]] = None,
    ) -> AlignmentResult:
        import time as _time

        from mauvealigner_tpu_torch.utils import timing

        timer = timing.GLOBAL
        _t = _time.perf_counter()
        with timer.phase("anchoring"):
            ml = self.find_mums(genomes)
            if callable(extra_matches):
                # deferred producer: sees the found anchors first, so it can
                # gate on their coverage (translated extant anchors engage
                # only where rep-rep anchoring is weak)
                extra_matches = extra_matches(ml)
            if extra_matches is not None and len(extra_matches):
                ml = ml.concat(extra_matches).dedup()
        timer.add("aln_anchor_s", _time.perf_counter() - _t)
        if self.options.debug:
            from mauvealigner_tpu_torch.core.validate import validate_match_list

            validate_match_list(ml, genomes)
        _t = _time.perf_counter()
        with timer.phase("lcb_determination"):
            ml, lcbs = self.determine_lcbs(genomes, ml)
        timer.add("aln_lcb_s", _time.perf_counter() - _t)
        _t = _time.perf_counter()
        if self.options.lcb_extension:
            with timer.phase("lcb_extension"):
                ml, lcbs = self.extend_lcbs(genomes, ml, lcbs)
        timer.add("aln_extension_s", _time.perf_counter() - _t)
        _t = _time.perf_counter()
        if self.options.recursive:
            with timer.phase("recursive_anchoring"):
                ml, lcbs = self.recursive_anchor(genomes, ml, lcbs)
        timer.add("aln_recursion_s", _time.perf_counter() - _t)
        _t = _time.perf_counter()
        with timer.phase("gapped_closure"):
            ivs = self.build_intervals(genomes, ml, lcbs, seq_profiles)
        timer.add("aln_closure_s", _time.perf_counter() - _t)
        if self.options.debug:
            from mauvealigner_tpu_torch.core.validate import validate_interval_list

            validate_interval_list(ivs, genomes)
        return AlignmentResult(ivs, lcbs, ml)
