"""Repeatoire: de-novo repeat-family detection by chained local multiple
alignment of a single genome.

Port of mauvealigner_tpu/models/repeatoire.py: host NumPy around the device
calls, which run on RepeatoireOptions.device (the sorted mer list and its
seed-group sort, every extension wave's batched Gotoh closure through the
CUDA kernels, the homology-HMM gate).

Reference: src/repeatoire.cpp (procrastAligner; 11-step roadmap at
:1819-1830).  Reproduced behaviors:

  * seed matches with multiplicity in [rmin, rmax], optional direct-only
    projection (SeedMatchEnumerator, src/SeedMatchEnumerator.h:59-141);
  * seed weight defaults to 0.9x the genome's default weight
    (LoadSMLs(0.9*defaultWeight), src/repeatoire.cpp:1850);
  * procrastination: families are processed in decreasing multiplicity order
    (ProcrastinationQueue max-heap, src/repeatoire.cpp:1413-1469);
  * chaining of diagonal-consistent seed groups (processChainableMatches,
    src/repeatoire.cpp:1002-1082) — expressed here as the same run-merge used
    for multi-MUMs, generalized to k-component repeat tables;
  * gapped flank extension with the homology HMM, window
    80*exp(-0.01*multiplicity) (ExtendMatch, src/repeatoire.cpp:1142-1408,
    window formula :1153), using batched profile DP instead of MUSCLE;
  * subsumption of lower-multiplicity families covered by processed ones
    (classification at src/repeatoire.cpp:963-989, simplified to coverage
    containment);
  * sum-of-pairs scoring with hoxd scores, gap open -100 extend -20
    (computeSPScore, src/repeatoire.cpp:1994,2511-2536);
  * XMFA + XML + `procrast.highest` statistics outputs
    (writeXmfa/writeXML, src/repeatoire.cpp:1609-1657,2682-2696).
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.analysis import backbone as bb
from mauvealigner_tpu_torch.analysis import sp as sp_mod
from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList
from mauvealigner_tpu_torch.core.sml import build_sml, load_sml
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.models.aligner import resolve_device
from mauvealigner_tpu_torch.ops import dp, matchops
from mauvealigner_tpu_torch.ops import hmm as hmm_ops
from mauvealigner_tpu_torch.seeds import SOLID_SEED, default_seed_weight, get_seed
from mauvealigner_tpu_torch.utils import timing


@dataclasses.dataclass
class RepeatoireOptions:
    z: int = 0                    # seed weight (--z); 0 = 0.9 * default
    rmin: int = 2
    rmax: int = 500
    only_direct: bool = False
    extend: bool = True           # --extend (default true, :1711)
    chain: bool = True            # --chain (default true, :1710)
    min_length: int = 1           # --l minimum repeat length (default 1, :1718)
    min_multiplicity: int = 2
    window_base: float = 80.0     # flank window 80*e^(-0.01*multi) (:1153)
    window_decay: float = 0.01
    window: int = -1              # --window: >=0 overrides the flank formula (:1155)
    w: int = 0                    # --w neighborhood window; 0 = seed_weight*3 (:1857)
    max_extension_rounds: int = 8
    gap_open: float = -100.0      # hoxd repeat params (:1994)
    gap_extend: float = -20.0
    hmm_identity: float = 0.7
    percent_id: float = 0.0       # --percentid: >0 adapts HMM identity (:1903)
    hmm_go_homologous: float = 0.008  # --h (default 0.008, :1716)
    hmm_go_unrelated: float = 0.001   # --u (default 0.001, :1738)
    posterior_threshold: float = 0.5
    subsume_overlap: float = 0.8  # component coverage fraction -> subsumed
    onlydirect: bool = False
    find_novel_subsets: bool = False  # --novel-subsets (default false, :1725)
    allow_redundant: bool = True  # --allow-redundant (default true, :1709)
    large_repeats: bool = False   # --large-repeats: crop order by length (:2559)
    small_repeats: bool = False   # --small-repeats (:2561; same key as sp here)
    only_extended: bool = False   # --onlyextended (:1722)
    # register subset-homologous segments found during gapped extension as
    # candidate records (--novel-matches default true, :1726,2201-2221)
    use_novel_matches: bool = True
    min_sp_score: float = 0.0     # --sp: keep only score > this (:2653)
    allow_tandem: bool = True     # --tandem (default true, :1735)
    two_hits: bool = False        # --two-hits: >=2 chained seeds to extend (:2154)
    solid: bool = False           # --solid seeds (:1733,1845)
    load_sml: bool = False        # --load-sml: reuse the on-disk SML cache (:1720)
    # torch device of every device phase (sorted mer list, seed-group sort,
    # extension DP, HMM gate): "cuda" runs the CUDA kernels, "cpu" the
    # plain-torch versions.  No fallback: "cuda" without a GPU raises.
    device: str = "cuda"


@dataclasses.dataclass
class RepeatFamily:
    starts: np.ndarray   # int64 [k] signed 1-based leftmost per component
    aln: np.ndarray      # bool [k, n_cols]
    score: float = 0.0
    # components adjacent to each other within the neighborhood window
    # (src/repeatoire.cpp:898); tandem records are never gapped-extended
    # (:1162) and are filtered when --tandem=0 (:2653)
    tandem: bool = False
    # number of seed windows chained into this record
    # (chained_matches.size(); gates extension under --two-hits, :2154)
    seed_count: int = 1

    @property
    def multiplicity(self) -> int:
        return len(self.starts)

    @property
    def n_cols(self) -> int:
        return self.aln.shape[1]

    def component_lengths(self) -> np.ndarray:
        return self.aln.sum(axis=1).astype(np.int64)

    def spans(self) -> np.ndarray:
        """[k, 2] absolute [left, right] per component."""
        lens = self.component_lengths()
        out = np.empty((len(lens), 2), np.int64)
        np.abs(self.starts, out=out[:, 0])
        out[:, 1] = out[:, 0] + lens - 1
        return out


def _component_symbols(flanks: List[np.ndarray], aln: np.ndarray) -> np.ndarray:
    """Per-component HMM symbol streams [k, T]: each component classified
    against the rest of the family, the batched analog of ExtendMatch's
    per-sequence detectAndApplyBackbone decode (src/repeatoire.cpp:1324)
    whose backbone segments carry per-component membership.  A component's
    column is MATCH when its base agrees with at least half of the other
    present bases, GAP when it (or every other component) is gapped.
    Fully vectorized (a per-column np.unique loop here once dominated the
    whole repeatoire pipeline)."""
    k, T = aln.shape
    if T == 0:
        return np.zeros((k, 0), np.int8)
    col_codes = np.full((k, T), 5, np.int8)  # 5 = gap
    for i in range(k):
        cols = np.nonzero(aln[i])[0]
        col_codes[i, cols] = np.minimum(flanks[i][: len(cols)], 4)
    counts = np.stack([(col_codes == b).sum(axis=0) for b in range(4)])  # [4, T]
    n_bases = counts.sum(axis=0)                  # [T]
    has_base = col_codes < 4                      # N (4) counts as no base
    safe = np.where(has_base, col_codes, 0).astype(np.int64)
    agree = counts[safe, np.arange(T)] - has_base  # others sharing my base
    others = n_bases[None, :] - has_base
    sym = np.where(
        agree * 2 >= np.maximum(others, 1), bb.SYM_MATCH, bb.SYM_TRANSVERSION
    ).astype(np.int8)
    sym[~has_base] = np.int8(bb.SYM_GAP)
    sym[(others == 0) & has_base] = np.int8(bb.SYM_GAP)
    return sym


def _component_symbols_batch(
    flanks_list: List[List[np.ndarray]],
    alns: List[np.ndarray],
    max_cells: int = 1 << 20,
) -> List[np.ndarray]:
    """_component_symbols over many jobs at once: jobs bucket by padded
    (component, column) shape and classify in slab-sized vector passes.
    Padded rows/columns are all-gap (code 5), which the classification maps
    to SYM_GAP; they are sliced off before returning."""
    out: List[Optional[np.ndarray]] = [None] * len(alns)
    groups: dict = {}
    for j, aln in enumerate(alns):
        k, T = aln.shape
        if T == 0 or k == 0:
            out[j] = np.zeros((k, 0), np.int8)
            continue
        kb = 1 << (k - 1).bit_length()
        Tb = max(16, -(-T // 64) * 64)
        groups.setdefault((kb, Tb), []).append(j)
    for (kb, Tb), idxs in groups.items():
        slab = max(1, max_cells // (kb * Tb))
        for off in range(0, len(idxs), slab):
            chunk = idxs[off : off + slab]
            J = len(chunk)
            A = np.zeros((J, kb, Tb), bool)
            Fm = np.zeros((J, kb, Tb), np.int8)  # flank codes by base rank
            for n, j in enumerate(chunk):
                aln = alns[j]
                k, T = aln.shape
                A[n, :k, :T] = aln
                cnts = aln.sum(axis=1)
                for i, f in enumerate(flanks_list[j]):
                    c = int(cnts[i])
                    if c:
                        Fm[n, i, :c] = np.minimum(f[:c], 4)
            rank = np.cumsum(A, axis=2, dtype=np.int32) - 1
            col_codes = np.where(
                A,
                np.take_along_axis(Fm, np.clip(rank, 0, Tb - 1), axis=2),
                np.int8(5),
            )
            counts = np.stack(
                [(col_codes == b).sum(axis=1) for b in range(4)], axis=1
            )  # [J, 4, Tb]
            n_bases = counts.sum(axis=1)              # [J, Tb]
            has_base = col_codes < 4
            safe = np.where(has_base, col_codes, 0).astype(np.int64)
            agree = (
                counts[
                    np.arange(J)[:, None, None],
                    safe,
                    np.arange(Tb)[None, None, :],
                ]
                - has_base
            )
            others = n_bases[:, None, :] - has_base
            sym = np.where(
                agree * 2 >= np.maximum(others, 1), bb.SYM_MATCH, bb.SYM_TRANSVERSION
            ).astype(np.int8)
            sym[~has_base] = np.int8(bb.SYM_GAP)
            sym[(others == 0) & has_base] = np.int8(bb.SYM_GAP)
            for n, j in enumerate(chunk):
                k, T = alns[j].shape
                out[j] = sym[n, :k, :T]
    return out  # type: ignore[return-value]


def _is_tandem(fam: RepeatFamily, window: int) -> bool:
    """Another component of the SAME record within the neighborhood window
    of a component's end (src/repeatoire.cpp:898)."""
    if fam.multiplicity < 2:
        return False
    spans = fam.spans()
    spans = spans[np.argsort(spans[:, 0])]
    gaps = spans[1:, 0] - spans[:-1, 1] - 1
    return bool((gaps <= window).any())


def _project_family(fam: RepeatFamily, comps: Sequence[int]) -> RepeatFamily:
    """Component-subset projection (MatchProjectionAdapter analog,
    src/MatchRecord.h:242): keep the given rows, drop all-gap columns."""
    rows = fam.aln[list(comps)]
    keep = rows.any(axis=0)
    return RepeatFamily(
        fam.starts[list(comps)].copy(), rows[:, keep], tandem=fam.tandem
    )


class Repeatoire:
    def __init__(self, options: Optional[RepeatoireOptions] = None):
        self.options = options or RepeatoireOptions()
        self.device = resolve_device(self.options.device)

    # -- step 1-2: seed matches + chaining ---------------------------------
    def seed_matches(self, genome: Genome) -> MatchList:
        o = self.options
        weight = o.z or max(5, int(round(0.9 * default_seed_weight(len(genome)))))
        self._seed = get_seed(weight, SOLID_SEED if o.solid else 0)
        if o.load_sml and genome.filename:
            sml = load_sml(genome, self._seed, cache=True, device=self.device)
        else:
            sml = build_sml(genome, self._seed, self.device)
        groups = matchops.build_seed_groups([sml], self.device)
        return matchops.repeat_matches_from_groups(
            groups,
            self._seed.length,
            min_multi=max(o.rmin, 2),
            max_multi=o.rmax,
            only_direct=o.only_direct or o.onlydirect,
        )

    def chain_seed_matches(
        self, ml: MatchList, genome: Genome
    ) -> Tuple[MatchList, np.ndarray]:
        """Merge diagonal-consistent consecutive seed groups (the ungapped
        chaining phase).  Reuses the multi-MUM run-merge on the component
        table, then extends runs to base-level maximality.

        Returns ``(matches, seed_counts)`` where ``seed_counts[i]`` is the
        number of seed windows chained into match i (the analog of the
        reference's ``chained_matches.size()``, src/repeatoire.cpp:2154,
        which gates gapped extension under --two-hits).  Matches identical
        after base-level extension keep the max count of their origins."""
        if len(ml) == 0:
            return ml, np.zeros(0, np.int64)
        pos0 = np.where(ml.starts != 0, np.abs(ml.starts) - 1, -1)
        rel_strand = np.where(ml.starts < 0, 1, 0).astype(np.int8)
        ref = np.zeros(len(ml), np.int32)  # column 0 = reference component
        merged = matchops.merge_collinear_runs(pos0, rel_strand, ref, self._seed.length)
        # seed windows per run: a run covering L columns holds L-z+1 windows
        counts = merged.lengths - self._seed.length + 1
        ext = matchops.extend_matches_maximal(
            merged, [genome.codes] * merged.n_seqs, dedup=False
        )
        rows = np.concatenate([ext.starts, ext.lengths[:, None]], axis=1)
        _, first_idx, inverse = np.unique(
            rows, axis=0, return_index=True, return_inverse=True
        )
        max_counts = np.zeros(len(first_idx), np.int64)
        np.maximum.at(max_counts, inverse, counts)
        order = np.argsort(first_idx, kind="stable")
        return ext.select(first_idx[order]), max_counts[order]

    # -- flank window (src/repeatoire.cpp:1153) ----------------------------
    def flank_window(self, multiplicity: int) -> int:
        o = self.options
        if o.window >= 0:  # --window override (src/repeatoire.cpp:1155)
            return o.window
        return max(4, int(o.window_base * math.exp(-o.window_decay * multiplicity)))

    def neighborhood_window(self) -> int:
        """--w: adjacency window for tandem detection and subset spawning
        (default seed_weight*3, src/repeatoire.cpp:1857)."""
        o = self.options
        return o.w if o.w > 0 else getattr(self._seed, "weight", 11) * 3

    # -- batched gapped extension -------------------------------------------
    def _gapped_extend_batch(
        self, genome: Genome, fams: List[RepeatFamily]
    ) -> Tuple[List[RepeatFamily], List[RepeatFamily]]:
        """Extend every family in lockstep waves (ExtendMatch equivalent,
        src/repeatoire.cpp:1142-1408).  Per wave, every family still
        extending contributes its current flank-alignment job; all jobs run
        in ONE batched closure call and ONE bucketed HMM pass (~16 device
        dispatches per wave instead of 2 per family).  Extension is safe to
        batch because it reads only the genome, never other families.

        Returns (extended families, novel records): a chain blocked by a
        subset-homologous segment registers that segment as a NOVEL record
        (use_novel_matches, src/repeatoire.cpp:2201-2221) so it can become
        a family of its own downstream."""
        o = self.options
        n = len(fams)
        cur = list(fams)
        novel_records: List[RepeatFamily] = []
        if o.max_extension_rounds <= 0:
            return cur, novel_records
        DIRS = (1, -1)  # right, then left (match space)
        dir_idx = np.zeros(n, np.int8)   # 0/1 -> DIRS index, 2 -> done
        rounds = np.zeros(n, np.int32)
        while True:
            jobs = []  # (family index, direction, window, flanks)
            for i in range(n):
                while dir_idx[i] < 2:
                    d = DIRS[dir_idx[i]]
                    fam = cur[i]
                    w = self.flank_window(fam.multiplicity)
                    lens = fam.component_lengths()
                    flanks = [
                        self._flank_codes(genome, int(fam.starts[k]), int(lens[k]), d, w)
                        for k in range(fam.multiplicity)
                    ]
                    if all(len(f) == 0 for f in flanks):
                        dir_idx[i] += 1
                        rounds[i] = 0
                        continue
                    jobs.append((i, d, w, flanks))
                    break
            if not jobs:
                break
            # align_region_groups expects uniform group arity: pad every
            # job's flank list with empty regions to the wave maximum (empty
            # regions never enter a merge, so per-group results are
            # unchanged) — ONE closure call per wave instead of one per
            # multiplicity class
            arity = max(len(j[3]) for j in jobs)
            empty = np.zeros(0, np.int64)
            padded = [
                list(j[3]) + [empty] * (arity - len(j[3])) for j in jobs
            ]
            timing.GLOBAL.add("rp_ext_waves", 1.0)
            timing.GLOBAL.add("rp_ext_jobs", float(len(jobs)))
            _t0 = time.perf_counter()
            # balanced merge tree: ceil(log2 arity) batched rounds per wave
            # instead of arity-1
            got = closure.hierarchical_align_region_groups(
                padded,
                closure.balanced_plan(arity),
                gap_open=o.gap_open,
                gap_extend=o.gap_extend,
                max_len=4096,
                device=self.device,
            )
            timing.GLOBAL.add("rp_ext_dp_s", time.perf_counter() - _t0)
            alns = [aln[: len(j[3])] for j, aln in zip(jobs, got)]
            homs = self._homology_columns_batch(
                genome, [j[3] for j in jobs], alns
            )
            for (i, d, w, flanks), aln, hom in zip(jobs, alns, homs):
                advance = True
                hom_cols, novel = self._extension_segments(aln, hom)
                if novel is not None and o.use_novel_matches:
                    nf = self._novel_record(cur[i], aln, d, novel)
                    if nf is not None:
                        novel_records.append(nf)
                if aln.shape[1] and hom_cols:
                    fam = cur[i]
                    ext = aln[:, :hom_cols]
                    added_per_comp = ext.sum(axis=1).astype(np.int64)
                    if d < 0:
                        new_aln = np.concatenate([ext[:, ::-1], fam.aln], axis=1)
                    else:
                        new_aln = np.concatenate([fam.aln, ext], axis=1)
                    new_starts = fam.starts.copy()
                    for k in range(fam.multiplicity):
                        s = int(fam.starts[k])
                        fwd = s > 0
                        genome_right = (d > 0) == fwd
                        if not genome_right:
                            new_starts[k] = (1 if fwd else -1) * (
                                abs(s) - int(added_per_comp[k])
                            )
                    cur[i] = RepeatFamily(new_starts, new_aln)
                    # a successful chain enables another round in the SAME
                    # direction (src/repeatoire.cpp:2318-2324); a failed one
                    # flips it (:2157-2162).  Exhausted flanks end the round
                    # via the empty-flank check at the top of the wave loop.
                    rounds[i] += 1
                    advance = rounds[i] >= o.max_extension_rounds
                if advance:
                    dir_idx[i] += 1
                    rounds[i] = 0
        return cur, novel_records

    @staticmethod
    def _novel_record(
        fam: RepeatFamily, aln: np.ndarray, d: int, novel
    ) -> Optional[RepeatFamily]:
        """Materialize a blocking subset-homologous extension segment as a
        standalone record: the reference registers these in its
        match-position lookup table so later queued records can chain onto
        them (use_novel_matches, src/repeatoire.cpp:2201-2221); here they
        become candidate families subject to the same procrastination order
        and subsumption."""
        members, a, b = novel
        rows = np.nonzero(members)[0]
        lens = fam.component_lengths()
        pref = np.cumsum(aln, axis=1, dtype=np.int64)
        starts_new = []
        for k in rows:
            s = int(fam.starts[k])
            L = int(lens[k])
            lo = int(pref[k, a - 1]) if a > 0 else 0
            hi = int(pref[k, b - 1])
            if hi <= lo:
                return None
            left = abs(s)
            right = left + L - 1
            fwd = s > 0
            if (d > 0) == fwd:  # flank sits on the genome's right side
                g_left = right + 1 + lo
            else:
                g_left = left - hi
            if g_left < 1:
                return None
            starts_new.append((1 if fwd else -1) * g_left)
        seg = aln[rows][:, a:b]
        seg = seg[:, seg.any(axis=0)]
        if d < 0:  # flank columns run away from the match: flip to genome order
            seg = seg[:, ::-1]
        if seg.shape[1] == 0:
            return None
        nf = RepeatFamily(np.asarray(starts_new, np.int64), np.ascontiguousarray(seg))
        nf.seed_count = 1
        return nf

    @staticmethod
    def _extension_segments(aln: np.ndarray, hom: np.ndarray):
        """(chainable column count, blocking subset segment) of one
        extension alignment.

        Reference semantics (src/repeatoire.cpp:2166-2189): ExtendMatch's
        backbone segments arrive in column order; only the segment NEAREST
        the record can extend it, and only when its multiplicity equals the
        record's.  Runs where <2 components are homologous are not backbone
        segments at all, so they never block — a full-multiplicity segment
        behind leading junk still chains (the junk columns ride along as
        the inter-chain fill that finalize() would add).  A nearer subset
        segment blocks chaining and is returned as (members bool[k],
        col_a, col_b) — the NOVEL MATCH the reference registers in its
        match-position lookup table (use_novel_matches, :2201-2221)."""
        T = aln.shape[1]
        if T == 0 or not hom.size:
            return 0, None
        k = aln.shape[0]
        sig = hom.T  # [T, k]
        change = np.ones(T, bool)
        change[1:] = np.any(sig[1:] != sig[:-1], axis=1)
        run_starts = np.nonzero(change)[0]
        run_ends = np.append(run_starts[1:], T)
        # member counts for ALL runs in one pass: component c is a member of
        # run [a, b) iff sig[a, c] and it has a base inside the run
        pref = np.cumsum(aln, axis=1, dtype=np.int32)  # [k, T]
        hi = pref[:, run_ends - 1]
        lo = np.where(run_starts > 0, pref[:, np.maximum(run_starts - 1, 0)], 0)
        members = sig[run_starts].T & (hi - lo > 0)    # [k, R]
        counts = members.sum(axis=0)
        cand = np.nonzero(counts >= 2)[0]
        if not len(cand):
            return 0, None
        # nearest >=2-member segment decides: chain to its end iff it has
        # full multiplicity (M_e->Multiplicity() == M_i's, :2175)
        r = cand[0]
        if counts[r] == k:
            return int(run_ends[r]), None
        return 0, (members[:, r], int(run_starts[r]), int(run_ends[r]))

    @classmethod
    def _chainable_cols(cls, aln: np.ndarray, hom: np.ndarray) -> int:
        return cls._extension_segments(aln, hom)[0]

    def _homology_columns_batch(
        self,
        genome: Genome,
        flanks_list: List[List[np.ndarray]],
        alns: List[np.ndarray],
    ) -> List[np.ndarray]:
        """Per-component homologous-column masks [k_j, T_j] for a wave of
        extension jobs: one HMM stream per (job, component) pair through the
        shared bucketed decode driver (ops/hmm.bucketed_decode)."""
        params = self._hmm_params(genome)
        streams: List[np.ndarray] = []
        shapes: List[Tuple[int, int]] = []
        for syms in _component_symbols_batch(flanks_list, alns):
            shapes.append(syms.shape)
            for c in range(syms.shape[0]):
                streams.append(syms[c])
        _t0 = time.perf_counter()
        decoded = hmm_ops.bucketed_decode(
            streams,
            params.log_trans(),
            np.log([0.9, 0.1]),
            mode="threshold0",
            threshold=self.options.posterior_threshold,
            emit_table=params.log_emit_table(),
            device=self.device,
        )
        timing.GLOBAL.add("rp_ext_hmm_s", time.perf_counter() - _t0)
        out: List[np.ndarray] = []
        pos = 0
        for k, T in shapes:
            hom = np.zeros((k, T), bool)
            for c in range(k):
                hom[c] = decoded[pos]
                pos += 1
            out.append(hom)
        return out

    def _hmm_params(self, genome: Genome):
        cached = getattr(self, "_hmm_params_cache", None)
        if cached is None or cached[0] is not genome:
            o = self.options
            gc = bb.compute_gc([genome])
            # --percentid > 0 adapts the emission identity
            # (adaptToPercentIdentity call, src/repeatoire.cpp:1903-1904);
            # transitions come from --h/--u (:1905-1906)
            identity = min(o.percent_id, 1.0) if o.percent_id > 0 else o.hmm_identity
            params = bb.adapted_params(
                gc,
                identity=identity,
                go_homologous=o.hmm_go_homologous,
                go_unrelated=o.hmm_go_unrelated,
                denovo=True,
            )
            self._hmm_params_cache = (genome, params)
            cached = self._hmm_params_cache
        return cached[1]

    # -- step 3-5: procrastinated gapped extension --------------------------
    def build_families(
        self,
        genome: Genome,
        ml: MatchList,
        seed_counts: Optional[np.ndarray] = None,
    ) -> List[RepeatFamily]:
        o = self.options
        fams: List[Tuple[int, int, RepeatFamily]] = []
        nw = self.neighborhood_window()
        for i in range(len(ml)):
            comps = ml.starts[i][ml.starts[i] != NO_MATCH]
            if len(comps) < o.min_multiplicity:
                continue
            aln = np.ones((len(comps), int(ml.lengths[i])), bool)
            fam = RepeatFamily(comps.copy(), aln)
            fam.tandem = _is_tandem(fam, nw)
            fam.seed_count = (
                int(seed_counts[i]) if seed_counts is not None else 1
            )
            fams.append((len(comps), int(ml.lengths[i]), fam))
        # procrastination queue: highest multiplicity first, then longest
        fams.sort(key=lambda t: (-t[0], -t[1]))
        # optimistic batched extension: a family's extension depends only on
        # the genome, never on `covered`, so extending every candidate in
        # lockstep waves (one batched DP + one batched HMM call per wave)
        # yields byte-identical output to the sequential loop — subsumed
        # candidates just waste their share of the batch (~25% measured).
        # Tandem records are never extended (src/repeatoire.cpp:1162); with
        # --two-hits only chains of >= 2 seeds extend (:2154).
        def _extendable(f: RepeatFamily) -> bool:
            if f.tandem:
                return False
            # --two-hits: only records chaining >= 2 seed windows extend
            # (chained_matches.size() > 1, src/repeatoire.cpp:2154); the
            # count is tracked through chaining, NOT inferred from n_cols
            # (base-level maximal extension lengthens single-seed matches
            # past the seed length, which would defeat the gate)
            if o.two_hits and getattr(f, "seed_count", 1) < 2:
                return False
            return True

        extended = {}
        if o.extend and fams:
            todo = [f for _, _, f in fams if _extendable(f)]
            ext_list, novel_records = self._gapped_extend_batch(genome, todo)
            extended = {id(f): e for f, e in zip(todo, ext_list)}
            for _, _, f in fams:
                ext = extended.get(id(f))
                if ext is not None:
                    # re-check adjacency on the grown geometry: extension can
                    # carry components into each other's window
                    ext.tandem = f.tandem or _is_tandem(ext, nw)
                else:
                    extended[id(f)] = f
            if novel_records:
                # novel records enter the procrastination order like any
                # other candidate; they extend at POP time (M_e->extended =
                # false in the reference) via the speculative wave in the
                # pop loop below — eagerly extending all of them here cost
                # 4x on repeat-dense genomes for zero output difference.
                # Overlapping parents spawn duplicate segments; dedup by
                # geometry first.
                seen_nov: set = set()
                uniq = []
                for nf in novel_records:
                    key = (tuple(nf.starts.tolist()), nf.n_cols)
                    if key not in seen_nov:
                        seen_nov.add(key)
                        uniq.append(nf)
                for nf in uniq:
                    nf.tandem = _is_tandem(nf, nw)
                    extended[id(nf)] = nf
                    fams.append((nf.multiplicity, nf.n_cols, nf))
                fams.sort(key=lambda t: (-t[0], -t[1]))
                novel_ids = {id(nf) for nf in uniq}
            else:
                novel_ids = set()
        else:
            novel_ids = set()
        covered = np.zeros(len(genome) + 2, dtype=bool)

        def _subsumed(f: RepeatFamily) -> bool:
            spans = f.spans()
            total = int((spans[:, 1] - spans[:, 0] + 1).sum())
            already = sum(int(covered[l : r + 1].sum()) for l, r in spans)
            return bool(total and already / total >= o.subsume_overlap)

        out: List[RepeatFamily] = []
        processed: List[RepeatFamily] = []
        spawned_sigs: set = set()
        # Pop-time extension for novel records (M_e->extended = false in the
        # reference: a novel extends when POPPED, so families popped later
        # are subsumption-tested against its EXTENDED footprint).  Extension
        # reads only the genome, never `covered`, so when the first surviving
        # novel pops we speculatively batch it with every remaining unpopped
        # novel that is not yet subsumed under CURRENT coverage (coverage
        # only grows, so that set is a superset of the eventual survivors):
        # exact sequential pop-time semantics, usually one batched call.
        novel_ext: dict = {}
        min_len = max(o.min_length, 1)
        for qi, (_, _, fam) in enumerate(fams):
            pre = fam
            if _subsumed(fam):
                continue  # subsumed by previously processed families
            if o.extend:
                fam = extended[id(pre)]
            is_novel = id(pre) in novel_ids
            if is_novel and o.extend and not fam.tandem:
                if id(pre) not in novel_ext:
                    wave_pre = [pre]
                    wave = [fam]
                    for _, _, g in fams[qi + 1 :]:
                        gf = extended.get(id(g), g)
                        if (
                            id(g) in novel_ids
                            and id(g) not in novel_ext
                            and not gf.tandem
                            and not _subsumed(g)
                        ):
                            wave_pre.append(g)
                            wave.append(gf)
                    ext_w, _ = self._gapped_extend_batch(genome, wave)
                    for gp, e in zip(wave_pre, ext_w):
                        e.tandem = e.tandem or _is_tandem(e, nw)
                        novel_ext[id(gp)] = e
                fam = novel_ext[id(pre)]
            if fam.n_cols < min_len:
                continue
            for l, r in fam.spans():
                covered[l : r + 1] = True
            if o.find_novel_subsets:
                out.extend(self._novel_subsets(fam, processed, spawned_sigs))
            processed.append(fam)
            out.append(fam)
        return [f for f in out if f.n_cols >= min_len]

    # -- novel subset generation (processNovelSubsetMatches,
    #    src/repeatoire.cpp:1474-1608; gated by --novel-subsets, :1725) ------
    def _novel_subsets(
        self, fam: RepeatFamily, processed: List[RepeatFamily], seen: set
    ) -> List[RepeatFamily]:
        """Spawn subset records: when an already-extended family M_j lies
        within the procrastination window of a strict subset (>=2, <mult) of
        the current family's component ends, the shared components of M_j
        become a new record (reference classification at
        src/repeatoire.cpp:963-989; spawn at :1514-1596).  Spawns whose M_i
        projection is already subsumed by M_j carry nothing novel and are
        dropped (:1560-1573)."""
        # adjacency uses the neighborhood window (w, :2101), not the
        # extension-flank formula
        w = self.neighborhood_window()
        spans_i = fam.spans()
        out: List[RepeatFamily] = []
        for mj in processed:
            if mj.multiplicity <= 2:
                continue
            spans_j = mj.spans()
            for rel_orient in (1, -1):
                # pairs (x, y): component x of fam adjacent (within w) to
                # component y of mj with the given relative orientation
                pairs: List[Tuple[int, int]] = []
                used_y: set = set()
                for x in range(fam.multiplicity):
                    o_x = 1 if fam.starts[x] > 0 else -1
                    for y in range(mj.multiplicity):
                        o_y = 1 if mj.starts[y] > 0 else -1
                        if o_x * o_y != rel_orient:
                            continue
                        if y in used_y:
                            continue
                        # adjacency: gap between the two spans on the genome
                        # (may be slightly negative when gapped extension
                        # overlapped the records, like the reference's
                        # behind-the-end window scan)
                        gap = max(
                            spans_i[x, 0] - spans_j[y, 1],
                            spans_j[y, 0] - spans_i[x, 1],
                        ) - 1
                        if -w <= gap <= w:
                            pairs.append((x, y))
                            used_y.add(y)
                            break
                shared = len(pairs)
                if shared < 2 or shared >= fam.multiplicity:
                    continue
                if shared == mj.multiplicity:
                    continue  # subset of mj itself, not novel (:983-986)
                ys = [y for _, y in pairs]
                sig = tuple(sorted(int(mj.starts[y]) for y in ys))
                if sig in seen:
                    continue  # same components as a previous spawn (:1494-1500)
                # nothing novel if fam's shared spans sit inside mj's (:1560-1573)
                if any(
                    spans_j[y, 0] <= spans_i[x, 0] and spans_i[x, 1] <= spans_j[y, 1]
                    for x, y in pairs
                ):
                    continue
                seen.add(sig)
                out.append(_project_family(mj, ys))
        return out

    def _flank_codes(
        self, genome: Genome, start: int, length: int, direction: int, w: int
    ) -> np.ndarray:
        """Flank of one component in 'moving away from the match' order
        (first element adjacent to the match edge), revcomp-adjusted."""
        left = abs(start)
        right = left + length - 1
        fwd = start > 0
        glen = len(genome)
        genome_right = (direction > 0) == fwd
        if genome_right:
            codes = genome.codes[right : min(right + w, glen)].astype(np.int8)
        else:
            codes = genome.codes[max(0, left - 1 - w) : left - 1].astype(np.int8)[::-1]
        if not fwd:
            out = codes.copy()
            acgt = out < 4
            out[acgt] = 3 - out[acgt]
            codes = out
        return codes

    # -- step 6: SP score ---------------------------------------------------
    @staticmethod
    def _family_col_codes(genome: Genome, fam: RepeatFamily) -> np.ndarray:
        k, T = fam.aln.shape
        col_codes = np.full((k, T), 5, np.int8)
        lens = fam.component_lengths()
        for i in range(k):
            codes = genome.sub_codes_signed(int(fam.starts[i]), int(lens[i]))
            col_codes[i, fam.aln[i]] = np.minimum(codes, 4)
        return col_codes

    def sp_score(self, genome: Genome, fam: RepeatFamily) -> float:
        """Sum-of-pairs hoxd score with affine gaps (computeSPScore,
        src/repeatoire.cpp:2511-2536).  Delegates to the shared
        analysis/sp.py implementation: both-gap columns are projected out
        per pair, and gap-run opens are charged per sequence."""
        o = self.options
        m, g = sp_mod.match_and_gap_scores(
            self._family_col_codes(genome, fam), dp.HOXD70, o.gap_open, o.gap_extend
        )
        return m + g

    def _sp_score_batch(self, genome: Genome, fams: List[RepeatFamily]) -> np.ndarray:
        """SP scores for many families in one grouped/padded pass."""
        o = self.options
        mats = [self._family_col_codes(genome, f) for f in fams]
        m, g = sp_mod.match_and_gap_scores_batch(
            mats, dp.HOXD70, o.gap_open, o.gap_extend
        )
        return m + g

    # -- per-nucleotide redundancy removal (--allow-redundant=0,
    #    src/repeatoire.cpp:2538-2658) ---------------------------------------
    def _crop_components(
        self, fam: RepeatFamily, left_crop: np.ndarray, right_crop: np.ndarray
    ) -> RepeatFamily:
        """Crop genome-left/right edges per component (CropLeft/CropRight,
        src/repeatoire.cpp:2596-2630); drop all-gap columns.  A component is
        never emptied: the reference caps every crop at Length-1
        (CropLeft(Length-1), :2607-2610), so a fully-subsumed component
        survives as a 1 bp stub at its genome-right end and the record's
        multiplicity is unchanged."""
        aln = fam.aln.copy()
        starts = fam.starts.copy()
        for k in range(fam.multiplicity):
            idx = np.flatnonzero(aln[k])
            n = len(idx)
            lc = min(int(left_crop[k]), n - 1)
            rc = min(int(right_crop[k]), n - 1 - lc)
            s = int(starts[k])
            if s > 0:
                # genome-left = alignment-left for a forward component
                if lc:
                    aln[k, idx[:lc]] = False
                    starts[k] = s + lc
                if rc:
                    aln[k, idx[n - rc :]] = False
            else:
                # reverse: genome-left bases sit in the LAST columns
                if lc:
                    aln[k, idx[n - lc :]] = False
                    starts[k] = -(abs(s) + lc)
                if rc:
                    aln[k, idx[:rc]] = False
        keep_cols = aln.any(axis=0)
        return RepeatFamily(starts, aln[:, keep_cols], tandem=fam.tandem)

    def _remove_redundancy(
        self, genome: Genome, fams: List[RepeatFamily]
    ) -> List[RepeatFamily]:
        """Assign every nucleotide to its best family (first claim in score
        order) and crop other families' component edges off the claimed
        territory (per-nucleotide ownership walk, src/repeatoire.cpp:2545-2634).
        Crop order: length with --large-repeats (:2559), SP score otherwise.

        Claims persist even when the claiming family is later dropped —
        the reference marks subsuming_match before cropping (:2590-2593)
        and never unmarks, so a record that subsequently fails the
        length/SP/tandem filters still blocks lower-ranked records.
        A fully-subsumed component is cropped to a 1 bp stub at its
        genome-right end, never dropped (CropLeft(Length-1), :2607-2610),
        so multiplicity is invariant under redundancy removal."""
        o = self.options
        if o.large_repeats:  # score_by_length (:89)
            key = lambda i: (-fams[i].n_cols, -fams[i].score)
        elif o.small_repeats:  # scorecmp (:67)
            key = lambda i: (-fams[i].multiplicity, -fams[i].score)
        else:  # score_by_sp (:78)
            key = lambda i: (-fams[i].score, -fams[i].multiplicity)
        order = sorted(range(len(fams)), key=key)
        owner = np.full(len(genome) + 2, -1, np.int64)
        out: List[RepeatFamily] = []
        rescore: List[int] = []  # indices into `out` needing a post-crop score
        for fi in order:
            f = fams[fi]
            spans = f.spans()
            # claim unowned nucleotides first (:2590-2593), then crop edges
            # owned by another record (:2596-2630)
            for l, r in spans:
                seg = owner[l : r + 1]
                seg[seg == -1] = fi
            k = f.multiplicity
            left_crop = np.zeros(k, np.int64)
            right_crop = np.zeros(k, np.int64)
            for ki, (l, r) in enumerate(spans):
                own = owner[l : r + 1] == fi
                if not own.any():
                    # fully subsumed: keep the genome-rightmost base (:2607)
                    left_crop[ki] = r - l
                    continue
                left_crop[ki] = int(np.argmax(own))
                right_crop[ki] = int(np.argmax(own[::-1]))
            if left_crop.any() or right_crop.any():
                f2 = self._crop_components(f, left_crop, right_crop)
                # recompute the SP score after cropping (:2643-2646); scores
                # are only read after the ownership walk, so the recompute
                # batches into one grouped pass at the end
                rescore.append(len(out))
                out.append(f2)
            else:
                out.append(f)
        if rescore:
            scores = self._sp_score_batch(genome, [out[i] for i in rescore])
            for i, sc in zip(rescore, scores):
                out[i].score = float(sc)
        return out

    # -- full pipeline ------------------------------------------------------
    def find_repeats(
        self,
        genome: Genome,
        matches: Optional[Tuple[MatchList, Optional[np.ndarray]]] = None,
    ) -> List[RepeatFamily]:
        """Full repeat-finding pipeline.  ``matches`` optionally supplies a
        precomputed (chained) match list + per-match seed counts so callers
        that already ran the seed phase (e.g. the CLI's --seeds output) do
        not pay for it twice."""
        o = self.options
        _t0 = time.perf_counter()
        if matches is not None:
            ml, seed_counts = matches
        else:
            ml = self.seed_matches(genome)
            seed_counts = None
            if o.chain:
                ml, seed_counts = self.chain_seed_matches(ml, genome)
        timing.GLOBAL.add("rp_seed_chain_s", time.perf_counter() - _t0)
        _t0 = time.perf_counter()
        fams = self.build_families(genome, ml, seed_counts)
        timing.GLOBAL.add("rp_build_s", time.perf_counter() - _t0)
        _t0 = time.perf_counter()
        if fams:
            for f, sc in zip(fams, self._sp_score_batch(genome, fams)):
                f.score = float(sc)
        timing.GLOBAL.add("rp_score_s", time.perf_counter() - _t0)
        _t0 = time.perf_counter()
        if not o.allow_redundant:
            fams = self._remove_redundancy(genome, fams)
        timing.GLOBAL.add("rp_redundancy_s", time.perf_counter() - _t0)
        # final filter chain (src/repeatoire.cpp:2636-2653): min length,
        # --onlyextended, SP score strictly above --sp, tandem filter
        out = []
        for f in fams:
            if f.n_cols < max(o.min_length, 1):
                continue
            if f.multiplicity < o.min_multiplicity:
                continue
            if o.only_extended and f.n_cols <= self._seed.length:
                continue
            if not (f.score > o.min_sp_score):
                continue
            if f.tandem and not o.allow_tandem:
                continue
            out.append(f)
        out.sort(key=lambda f: (-f.multiplicity, -f.score))
        return out


def read_repeats_xmfa(src: Union[str, TextIO]) -> List[RepeatFamily]:
    """Read a repeat XMFA (each block = one family; entries share seq 1)."""
    if isinstance(src, str):
        with open(src) as fh:
            return read_repeats_xmfa(fh)
    fams: List[RepeatFamily] = []
    header_re = re.compile(r">\s*\d+:(\d+)-(\d+)\s+([+-])")
    starts: List[int] = []
    rows: List[str] = []
    cur: Optional[str] = None

    def flush_entry():
        nonlocal cur
        if cur is not None:
            rows.append(cur)
        cur = None

    def flush_block():
        nonlocal starts, rows
        flush_entry()
        if starts:
            width = max(len(r) for r in rows)
            aln = np.zeros((len(rows), width), bool)
            for i, r in enumerate(rows):
                row = np.frombuffer(r.ljust(width, "-").encode(), np.uint8)
                aln[i] = row != ord("-")
            fams.append(RepeatFamily(np.array(starts, np.int64), aln))
        starts, rows = [], []

    for line in src:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        if line.startswith("="):
            flush_block()
        elif line.startswith(">"):
            flush_entry()
            m = header_re.match(line)
            if m:
                sign = 1 if m.group(3) == "+" else -1
                starts.append(sign * int(m.group(1)))
                cur = ""
        elif cur is not None:
            cur += line.strip()
    flush_block()
    return fams


# -- outputs (writeXmfa / writeXML / procrast.highest) ----------------------

def write_repeats_xmfa(
    fams: Sequence[RepeatFamily], genome: Genome, out: Union[str, TextIO], width: int = 80
) -> None:
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_repeats_xmfa(fams, genome, fh, width)
            return
    fh = out
    fh.write("#FormatVersion Mauve1\n")
    fh.write(f"#Sequence1File\t{genome.filename or genome.name}\n")
    for fam in fams:
        lens = fam.component_lengths()
        for k in range(fam.multiplicity):
            s = int(fam.starts[k])
            left = abs(s)
            right = left + int(lens[k]) - 1
            strand = "+" if s > 0 else "-"
            fh.write(f"> 1:{left}-{right} {strand} {genome.filename or genome.name}\n")
            bases = genome.subseq_signed(s, int(lens[k]))
            row = np.full(fam.n_cols, ord("-"), np.uint8)
            row[fam.aln[k]] = np.frombuffer(bases.encode(), np.uint8)
            text = row.tobytes().decode()
            for c in range(0, len(text), width):
                fh.write(text[c : c + width] + "\n")
        fh.write("=\n")


def write_repeats_xml(
    fams: Sequence[RepeatFamily], genome: Genome, out: Union[str, TextIO]
) -> None:
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_repeats_xml(fams, genome, fh)
            return
    fh = out
    fh.write('<?xml version="1.0"?>\n<repeats sequence="%s">\n' % (genome.name or "seq"))
    for i, fam in enumerate(fams):
        fh.write(
            f'  <family id="{i}" multiplicity="{fam.multiplicity}" '
            f'columns="{fam.n_cols}" score="{fam.score:.1f}">\n'
        )
        for k in range(fam.multiplicity):
            l, r = fam.spans()[k]
            strand = "+" if fam.starts[k] > 0 else "-"
            fh.write(f'    <component left="{l}" right="{r}" strand="{strand}"/>\n')
        fh.write("  </family>\n")
    fh.write("</repeats>\n")


def write_highest_stats(fams: Sequence[RepeatFamily], out: Union[str, TextIO]) -> None:
    """Per-multiplicity best-scoring family table (`procrast.highest`,
    src/repeatoire.cpp:2682-2696)."""
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_highest_stats(fams, fh)
            return
    fh = out
    best = {}
    for fam in fams:
        cur = best.get(fam.multiplicity)
        if cur is None or fam.score > cur.score:
            best[fam.multiplicity] = fam
    fh.write("multiplicity\tcolumns\tscore\n")
    for mult in sorted(best, reverse=True):
        fam = best[mult]
        fh.write(f"{mult}\t{fam.n_cols}\t{fam.score:.1f}\n")

def write_score_out(
    fams: Sequence[RepeatFamily], genome: Genome, out: Union[str, TextIO]
) -> None:
    """Per-family score + alignment info (--score-out, src/repeatoire.cpp:2496,
    :1732).  One stanza per family: header with multiplicity/columns/SP score
    and the component coordinate list."""
    if isinstance(out, str):
        with open(out, "w") as fh:
            write_score_out(fams, genome, fh)
            return
    fh = out
    for i, fam in enumerate(fams, 1):
        fh.write(
            f"#procrastAlignment {i} multiplicity={fam.multiplicity} "
            f"columns={fam.n_cols} spscore={fam.score:.1f}"
            f"{' tandem' if fam.tandem else ''}\n"
        )
        spans = fam.spans()
        for k in range(fam.multiplicity):
            strand = "+" if fam.starts[k] > 0 else "-"
            fh.write(f"{spans[k, 0]}\t{spans[k, 1]}\t{strand}\n")
