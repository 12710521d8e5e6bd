"""K2: multi-way mer merge and multi-MUM enumeration, in torch.

Port of the device path of mauvealigner_tpu/ops/matchops.py (libMems
MatchFinder/MemHash in the reference: MaskedMemHash at
src/mauveAligner.cpp:523-530, SeedMatchEnumerator at
src/SeedMatchEnumerator.h:59-141).  Everything is sorts plus segmented
scans:

  1. concatenate every genome's (canonical key, position) list, tagged with
     the genome id, and sort by (mer, genome, position);
  2. group identical mers (a "seed group"); within a group classify each
     occurrence as genome-unique or repeated;
  3. hash each group's kept members into an order-independent 64-bit
     signature (diagonal invariants included);
  4. merge runs of consecutive reference windows with equal signatures into
     one match, then
  5. extend matches base by base to maximality on the host (native C++).

Strand handling follows SeedMatchEnumerator::SetDirection
(src/SeedMatchEnumerator.h:127-141): the first participating genome is the
reference component (always forward); a component whose canonical-strand
bit differs from the reference's gets a negative start.

All integer arithmetic matches the JAX package bit for bit: int64 products
and sums wrap in two's complement, and every `>>` of a possibly negative
int64 is masked to emulate a logical shift, exactly as there.

The host seed-group path over sorted mer lists (build_seed_groups and what
reads it: find_multi_mums for the SML disk cache, repeat_matches_from_groups
and merge_collinear_runs for repeatoire) is the JAX package's host NumPy
after one device sort.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.core.match import NO_MATCH, MatchList
from mauvealigner_tpu_torch.core.sml import SortedMerList
from mauvealigner_tpu_torch.genome.sequence import CODE_N, Genome
from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.ops.merops import INVALID_KEY
from mauvealigner_tpu_torch.utils import timing

_INT32_MAX = np.iinfo(np.int32).max
_INT64_MAX = np.iinfo(np.int64).max

_MIX_C1 = -7046029254386353131  # 0x9E3779B97F4A7C15 as signed
_MIX_C2 = -4417276706812531889  # 0xC2B2AE3D27D4EB4F
_MIX_C3 = -8796714831421723037  # 0x85EBCA77C2B2AE63


def _global_sort(keys: torch.Tensor, seq_ids: torch.Tensor, positions: torch.Tensor,
                 full_sort: bool = False):
    """Sort concatenated mer-list entries by (mer, genome, position), the
    strand bit (key LSB) carried along.  Replaces both _global_sort and
    _global_sort_packed of the JAX package (the packed variant only cut
    sort operands on the TPU).

    Precondition unless full_sort: entries with equal mer arrive in
    (genome, position) order, which the single-device producers guarantee
    (the per-genome lists are concatenated in genome order and each is in
    position order; the gap search lays regions out gap-major,
    genome-minor).  One stable sort by mer then gives the full lexicographic
    order.  full_sort sorts by (genome, position) first, for entries in any
    order (a mesh partition received from several shards)."""
    if full_sort:
        o = torch.sort((seq_ids.to(torch.int64) << 32) | positions.to(torch.int64),
                       stable=True).indices
        keys, seq_ids, positions = keys[o], seq_ids[o], positions[o]
    mer_s, order = torch.sort(keys >> 1, stable=True)
    strand_s = (keys[order] & 1).to(torch.int32)
    return mer_s, seq_ids[order], positions[order], strand_s


def _mix64(x: torch.Tensor, c: int) -> torch.Tensor:
    """SplitMix64-style finalizer (wrapping int64 arithmetic)."""
    x = x * c
    x = x ^ ((x >> 30) & 0x3FFFFFFFF)
    x = x * -4658895280553007687  # 0xBF58476D1CE4E5B9
    x = x ^ ((x >> 27) & 0x1FFFFFFFFF)
    return x


def _carry_last2(va, vb, flags, reverse=False):
    """Per-entry (va, vb) of the nearest flagged entry at/before each
    position (at/after with reverse=True); positions before any flag keep
    their own values.  A cummax (cummin from the end) over flagged indices
    finds each entry's source."""
    n = va.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=va.device)
    if reverse:
        idx = torch.where(flags, iota, n).flip(0).cummin(0).values.flip(0)
        ok = idx < n
    else:
        idx = torch.where(flags, iota, -1).cummax(0).values
        ok = idx >= 0
    safe = idx.clamp(0, n - 1)
    out = tuple(torch.where(ok, v[safe], v) for v in (va, vb) if v is not None)
    return out if vb is not None else out[0]


def _sig_phase(keys, seq_ids, positions, seq_mask, n_seqs, min_multi, full_sort=False):
    """Grouping half of the candidate search: sort by (mer, genome, pos),
    detect seed groups, per-genome uniqueness, reference selection, and the
    order-independent 64-bit group signature.

    Returns per-entry tensors in sorted order: seg ids, kept mask, rep mask
    (the group's reference entry), group signature (incl. multiplicity),
    genome ids, window positions, signed 1-based positions, reference
    positions.  Segments are contiguous in sorted order, so every
    per-segment reduction is a cumsum plus monotone cummax/cummin fills."""
    mer_s, seq_s, pos_s, strand_s = _global_sort(keys, seq_ids, positions, full_sort)
    dev = mer_s.device
    valid = mer_s != (INVALID_KEY >> 1)

    new_seg = mer_s != torch.cat([mer_s[:1] - 1, mer_s[:-1]])
    is_end = torch.cat([new_seg[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    seg_id = torch.cumsum(new_seg, 0, dtype=torch.int32) - 1
    same_ms = (~new_seg) & (seq_s == torch.cat([seq_s[:1] - 1, seq_s[:-1]]))
    next_same = torch.cat([same_ms[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
    occ_unique = valid & ~same_ms & ~next_same
    kept = occ_unique & (seq_mask[seq_s.clamp(0, n_seqs - 1).long()] > 0)

    # segment kept-count broadcast per entry: cumsum + monotone boundary
    # fills (segment-start bases and segment-end totals are nondecreasing)
    k32 = kept.to(torch.int32)
    cs = torch.cumsum(k32, 0, dtype=torch.int32)
    base = torch.where(new_seg, cs - k32, 0).cummax(0).values
    end = torch.where(is_end, cs, _INT32_MAX).flip(0).cummin(0).values.flip(0)
    count_here = end - base
    kept = kept & (count_here >= min_multi)

    # reference = first kept entry of the segment; its (pos, strand) reach
    # every kept entry via a forward carry
    is_rep = kept & (cs == base + 1)
    ref_pos, ref_strand = _carry_last2(pos_s, strand_s, is_rep)
    rel = strand_s ^ ref_strand
    pos64 = pos_s.to(torch.int64)
    ref64 = ref_pos.to(torch.int64)
    inv = torch.where(rel == 0, pos64 - ref64, pos64 + ref64)

    token = (
        (seq_s.to(torch.int64) << 33)
        | (rel.to(torch.int64) << 32)
        | (inv & 0xFFFFFFFF)
    )
    m1 = _mix64(_mix64(token + 1, _MIX_C1) ^ _mix64(token + 7, _MIX_C2), _MIX_C3)

    # order-independent segment signature = wrapping int64 segment sum of
    # the member mixes: cumsum with carry-filled segment boundaries
    contrib = torch.where(kept, m1, 0)
    cs64 = torch.cumsum(contrib, 0)
    base64 = _carry_last2(cs64 - contrib, None, new_seg)
    end64 = _carry_last2(cs64, None, is_end, reverse=True)
    rep_sig1 = (end64 - base64) + count_here.to(torch.int64) * _MIX_C3
    signed_pos = torch.where(rel == 0, pos_s + 1, -(pos_s + 1))
    return seg_id, kept, is_rep, rep_sig1, seq_s, pos_s, signed_pos, ref_pos


def device_mum_candidates(
    keys: torch.Tensor,       # int64 [N] canonical keys (strand LSB)
    seq_ids: torch.Tensor,    # int32 [N]
    positions: torch.Tensor,  # int32 [N] 0-based window starts
    seq_mask: torch.Tensor,   # int32 [n_seqs] 1 = genome participates
    n_seqs: int,
    cap: int,
    min_multi: int = 2,
) -> torch.Tensor:
    """Unique multi-MUM candidate runs on the device.

    Returns the packed int32 table [cap + 1, n_seqs + 2] of the JAX
    package: row 0 holds n_runs; row 1 + r holds run r's signed 1-based
    first-window starts per genome (0 = absent) and then [p0_min, p0_max].
    Runs past `cap` are dropped (the caller re-runs with a larger cap)."""
    assert min_multi >= 2, "representative compaction requires min_multi >= 2"
    N = keys.shape[0]
    dev = keys.device
    (seg_id, kept, is_rep, rep_sig1, seq_s, pos_s, signed_pos, _) = _sig_phase(
        keys, seq_ids, positions, seq_mask, n_seqs, min_multi
    )

    # group representatives by (signature, p0, segment): the JAX package
    # sorts by the signature as two signed int32 keys (hi, lo), which is the
    # order of the int64 signature with bit 31 flipped
    rep = torch.nonzero(is_rep).squeeze(1)  # ascending = segment order
    sig = rep_sig1[rep] ^ (1 << 31)
    p0 = pos_s[rep]
    order = torch.sort(p0, stable=True).indices
    order = order[torch.sort(sig[order], stable=True).indices]
    a_s, p0_s, segid_s = sig[order], p0[order], seg_id[rep][order]
    R = a_s.shape[0]
    cont = torch.zeros(R, dtype=torch.bool, device=dev)
    cont[1:] = (a_s[1:] == a_s[:-1]) & (p0_s[1:] == p0_s[:-1] + 1)
    run_start = ~cont
    run_end = torch.cat([~cont[1:], torch.ones(1, dtype=torch.bool, device=dev)])[:R]
    run_id = torch.cumsum(run_start, 0) - 1
    n_runs = run_start.sum()

    # drop semantics: out-of-range and unused rows aim at the spare row `cap`
    # (only the spare row ever sees duplicate indices), sliced off below
    row = torch.where(run_id < cap, run_id, cap)
    span_tab = torch.full((cap + 1, 2), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(row)
    span_tab.index_put_((torch.where(run_start, row, cap), zero), p0_s)
    span_tab.index_put_((torch.where(run_end, row, cap), zero + 1), p0_s)

    # run-first segments -> run row, then scatter their kept components
    seg_runfirst_row = torch.full((N + 1,), cap, dtype=torch.int64, device=dev)
    seg_runfirst_row.index_put_(
        (torch.where(run_start, segid_s.to(torch.int64), N),),
        torch.where(run_start, row, cap),
    )
    k = torch.nonzero(kept).squeeze(1)
    comp_row = seg_runfirst_row[seg_id[k].to(torch.int64)]
    comp_tab = torch.zeros((cap + 1, n_seqs), dtype=torch.int32, device=dev)
    comp_tab.index_put_((comp_row, seq_s[k].to(torch.int64)), signed_pos[k])

    head = torch.zeros((1, n_seqs + 2), dtype=torch.int32, device=dev)
    head[0, 0] = n_runs.to(torch.int32)
    packed = torch.cat([comp_tab[:cap], span_tab[:cap]], dim=1)
    return torch.cat([head, packed], dim=0)


def mum_runs_from_sig_entries(
    sig: torch.Tensor,   # int64 [N] group signature (incl. multiplicity)
    p0: torch.Tensor,    # int32 [N] group reference window position
    seq: torch.Tensor,   # int32 [N] (-1 = padding)
    spos: torch.Tensor,  # int32 [N] signed 1-based window position
    n_seqs: int,
    cap: int,
) -> torch.Tensor:
    """Run-merging half of the candidate search for entries in arbitrary
    order (the mesh path: entries arrive by an all-to-all keyed by
    hash(signature), so all windows of one diagonal run land on one shard,
    but interleaved).  Entries of one seed group share (sig, p0).  Returns
    the packed [cap+1, n_seqs+2] table of device_mum_candidates.

    The JAX package's 4-key sort (invalid flag, signature as signed int32
    halves, p0) is three stable sorts from the last key to the first; the
    halves' order is the int64 signature's with bit 31 flipped."""
    N = sig.shape[0]
    dev = sig.device
    valid = seq >= 0
    o = torch.sort(p0, stable=True).indices
    o = o[torch.sort(sig[o] ^ (1 << 31), stable=True).indices]
    o = o[torch.sort((~valid[o]).to(torch.int32), stable=True).indices]
    sig_s, p0_s, seq_s, spos_s, valid_s = sig[o], p0[o], seq[o], spos[o], valid[o]
    iota = torch.arange(N, dtype=torch.int64, device=dev)
    prev_same = torch.zeros(N, dtype=torch.bool, device=dev)
    prev_same[1:] = (sig_s[1:] == sig_s[:-1]) & (p0_s[1:] == p0_s[:-1])
    new_seg = valid_s & ~prev_same
    seg_id = torch.cumsum(new_seg, 0) - 1

    # per-segment signature / p0 from the segment's first entry (JAX:
    # .at[seg_id].min over valid entries' indices)
    seg_first = torch.full((N,), N - 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_id.clamp(min=0), torch.where(valid_s, iota, N - 1), "amin"
    )
    n_segs = new_seg.sum()
    seg_valid = iota < n_segs
    s_sig, s_p0 = sig_s[seg_first], p0_s[seg_first]
    cont = torch.zeros(N, dtype=torch.bool, device=dev)
    cont[1:] = seg_valid[1:] & (s_sig[1:] == s_sig[:-1]) & (s_p0[1:] == s_p0[:-1] + 1)
    run_start = seg_valid & ~cont
    run_id = torch.cumsum(run_start, 0) - 1
    n_runs = run_start.sum()
    run_end = torch.zeros(N, dtype=torch.bool, device=dev)
    run_end[:-1] = ~cont[1:]
    run_end[-1:] = True
    run_end &= seg_valid
    row_of_seg = torch.where(seg_valid & (run_id < cap), run_id, cap)
    # out-of-range and unused rows aim at the spare row `cap`, sliced off
    span_tab = torch.full((cap + 1, 2), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(row_of_seg)
    span_tab.index_put_((torch.where(run_start, row_of_seg, cap), zero), s_p0)
    span_tab.index_put_((torch.where(run_end, row_of_seg, cap), zero + 1), s_p0)
    # components of run-first segments scatter into the comp table
    comp_row_of_seg = torch.where(run_start, row_of_seg, cap)
    comp_row = torch.where(valid_s, comp_row_of_seg[seg_id.clamp(0, N - 1)], cap)
    comp_tab = torch.zeros((cap + 1, n_seqs), dtype=torch.int32, device=dev)
    comp_tab.index_put_((comp_row, seq_s.clamp(0, n_seqs - 1).to(torch.int64)), spos_s)
    head = torch.zeros((1, n_seqs + 2), dtype=torch.int32, device=dev)
    head[0, 0] = n_runs.to(torch.int32)
    return torch.cat([head, torch.cat([comp_tab[:cap], span_tab[:cap]], dim=1)], dim=0)


def _concat_device_smls(smls_dev):
    """Concatenate per-genome (keys, positions) device tensors in genome
    order, with the genome id of every entry."""
    keys = torch.cat([k for k, _ in smls_dev])
    pos = torch.cat([p for _, p in smls_dev])
    seq_ids = torch.cat(
        [
            torch.full((k.shape[0],), i, dtype=torch.int32, device=k.device)
            for i, (k, _) in enumerate(smls_dev)
        ]
    )
    return keys, seq_ids, pos


def _sketch_compact(keys, seq_ids, positions, mod: int):
    """Keep the entries whose strand-free mer hashes to 0 mod `mod`, in
    order (a compaction by mask: one elementwise pass, no sort), so a
    sketched search sorts ~1/mod of the entries.  Port of the JAX package's
    matchops._sketch_compact; the JAX version scatters into a fixed-size
    buffer sized 1.25x the expected count, which only a hash skew beyond
    that margin would overflow."""
    h = _mix64((keys >> 1) + 11, _MIX_C2)
    keep = (keys != INVALID_KEY) & (h % mod == 0)
    return keys[keep], seq_ids[keep], positions[keep]


def find_multi_mums_device(
    genomes: Sequence[Genome],
    smls_dev,
    min_multi: int = 2,
    nway: bool = False,
    seq_mask: Optional[np.ndarray] = None,
    extend: bool = True,
    seed_length: int = 0,
    initial_cap: Optional[int] = None,
    sketch_mod: int = 1,
) -> MatchList:
    """Unique multi-MUM search on the device of the given mer lists.

    smls_dev: per genome, (keys int64, positions int32) tensors in position
    order (core.sml.build_mer_list_device).

    On repeat-dense input the run count can exceed the capacity heuristic;
    the search then re-runs with the cap raised to the next power of two
    covering the actual count (never truncates).  initial_cap overrides the
    heuristic (tests exercise the retry with a tiny cap).

    sketch_mod > 1 subsamples the mer space by hash (1/mod of the windows
    enter the sort) — a MinHash-style sketch for distance estimation and
    coverage gating.  Base-level extension still grows each sampled seed to
    its full maximal match, so long matches keep their true lengths; only
    matches spanning fewer than ~mod seed windows can be missed entirely.
    """
    n_seqs = len(genomes)
    mask = np.ones(n_seqs, np.int32) if seq_mask is None else np.asarray(seq_mask, np.int32)
    keys, seq_ids, pos = _concat_device_smls(smls_dev)
    if sketch_mod > 1:
        keys, seq_ids, pos = _sketch_compact(keys, seq_ids, pos, sketch_mod)
    N = int(keys.shape[0])
    timing.GLOBAL.add("k2_sort_entries", float(N))
    if N == 0:
        return MatchList.empty(n_seqs)
    cap = initial_cap if initial_cap is not None else max(1 << 14, N >> 3)
    ml = _candidates_with_retry(
        keys, seq_ids, pos, torch.from_numpy(mask).to(keys.device), n_seqs, cap,
        min_multi, seed_length,
    )
    if extend and len(ml):
        t0 = time.perf_counter()
        ml = extend_matches_maximal(ml, [g.codes for g in genomes])
        timing.GLOBAL.add("k2_extend_s", time.perf_counter() - t0)
    if nway:
        ml = ml.multiplicity_filter(n_seqs)
    return ml


def _candidates_with_retry(
    keys, seq_ids, pos, mask, n_seqs, cap, min_multi, seed_length
) -> MatchList:
    """Run device_mum_candidates, doubling cap on overflow, and decode."""
    while True:
        t0 = time.perf_counter()
        table = device_mum_candidates(keys, seq_ids, pos, mask, n_seqs, cap, min_multi)
        timing.GLOBAL.add("k2_dispatch_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        n_runs = int(table[0, 0])
        if n_runs <= cap:
            head = table[: n_runs + 1].cpu().numpy()
            timing.GLOBAL.add("k2_fetch_s", time.perf_counter() - t0)
            break
        # capacity overflow (repeat-dense input): raise to the covering power
        # of two and re-run — truncating here would silently drop anchors
        cap = 1 << int(n_runs - 1).bit_length()
    return decode_mum_table(head, n_seqs, cap, seed_length)


def decode_mum_table(
    head: np.ndarray, n_seqs: int, cap: int, seed_length: int
) -> MatchList:
    """Decode a device_mum_candidates table (host side); `head` holds row 0
    and at least the first n_runs run rows."""
    r = int(head[0, 0])
    if r == 0:
        return MatchList.empty(n_seqs)
    if r > cap:
        warnings.warn(
            f"multi-MUM run capacity overflow: {r} runs > cap {cap}; "
            "result truncated (raise cap for highly repetitive inputs)"
        )
        r = cap
    if r > head.shape[0] - 1:
        raise ValueError(f"decode_mum_table: {r} runs but only {head.shape[0] - 1} rows")
    packed = head[1 : r + 1]
    comp, span = packed[:, :n_seqs], packed[:, n_seqs:]
    ok = (span[:, 0] >= 0) & (span[:, 1] >= span[:, 0])
    comp, span = comp[ok], span[ok]
    run_len = span[:, 1] - span[:, 0]
    lengths = run_len + seed_length
    # rev comps stored at the run-first window slide left by run_len
    starts = comp.astype(np.int64)
    rev = starts < 0
    starts[rev] = starts[rev] + run_len[np.nonzero(rev)[0]]
    return MatchList(starts, lengths.astype(np.int64))


def extend_matches_maximal(
    match_list: MatchList, genome_codes: Sequence[np.ndarray], chunk: int = 64,
    dedup: bool = True,
) -> MatchList:
    """Extend every match to base-level maximality and deduplicate.

    Mirrors MemHash's seed extension: grow left/right in match space while
    every participating genome agrees on the next column's base (ambiguity
    codes never match).  Vectorized host pass over all matches at once,
    `chunk` columns per iteration.  With ``dedup=False`` the output keeps a
    1:1 row correspondence with the input (callers that carry per-match
    metadata deduplicate themselves).
    """
    if len(match_list) == 0:
        return match_list
    starts = match_list.starts.copy()
    lengths = match_list.lengths.copy()
    n, n_seqs = starts.shape
    # native host runtime fast path (C++; see native/mauve_native.cpp)
    from mauvealigner_tpu_torch import native

    mod = native.get()
    if mod is not None:
        codes_bytes = [np.ascontiguousarray(c, dtype=np.uint8).tobytes() for c in genome_codes]
        s_out, l_out = mod.extend_matches(
            codes_bytes,
            np.ascontiguousarray(starts, dtype=np.int64).tobytes(),
            np.ascontiguousarray(lengths, dtype=np.int64).tobytes(),
            n,
            n_seqs,
        )
        starts = np.frombuffer(s_out, np.int64).reshape(n, n_seqs).copy()
        lengths = np.frombuffer(l_out, np.int64).copy()
        out = MatchList(starts, lengths)
        return out.dedup() if dedup else out
    seq_lens = np.array([len(c) for c in genome_codes], dtype=np.int64)

    def gather_col(offsets_from_end: np.ndarray, side: str) -> np.ndarray:
        """Base value per (match, seq) at `offsets_from_end` columns beyond
        the current match boundary; 255 = out of bounds / absent."""
        vals = np.full((n, n_seqs), 255, np.uint8)
        for j in range(n_seqs):
            s = starts[:, j]
            pres = s != NO_MATCH
            fwd = s > 0
            left0 = np.abs(s) - 1
            if side == "right":
                # match-space right: fwd reads left0+len-1+d; rev reads left0-d
                idx = np.where(fwd, left0 + lengths - 1 + offsets_from_end, left0 - offsets_from_end)
            else:
                # match-space left: fwd reads left0-d; rev reads left0+len-1+d
                idx = np.where(fwd, left0 - offsets_from_end, left0 + lengths - 1 + offsets_from_end)
            ok = pres & (idx >= 0) & (idx < seq_lens[j])
            v = np.full(n, 255, np.uint8)
            codes_j = genome_codes[j]
            v[ok] = codes_j[idx[ok]]
            flip = ok & ~fwd
            v[flip & (v < 4)] = 3 - v[flip & (v < 4)]
            vals[:, j] = v
        return vals

    for side in ("right", "left"):
        active = np.ones(n, dtype=bool)
        guard = 0
        while active.any() and guard < 10**6:
            guard += 1
            ext = np.zeros(n, dtype=np.int64)
            full = np.zeros(n, dtype=bool)
            # agreement run length within the next `chunk` columns
            agree_so_far = active.copy()
            for d in range(1, chunk + 1):
                col = gather_col(np.full(n, d, np.int64), side)
                pres = starts != NO_MATCH
                ref = col[np.arange(n), np.argmax(pres, axis=1)]
                match_col = (
                    (ref < 4)
                    & np.all((col == ref[:, None]) | ~pres, axis=1)
                )
                agree_so_far &= match_col
                ext = np.where(agree_so_far, d, ext)
                full = agree_so_far & (d == chunk)
                if not agree_so_far.any():
                    break
            grow = ext > 0
            if grow.any():
                fwd = starts > 0
                rev = starts < 0
                ext_b = np.broadcast_to(ext[:, None], starts.shape)
                if side == "right":
                    # reverse comps grow leftward in genome coords: |start|
                    # decreases, i.e. the negative start moves toward zero
                    sel = rev & grow[:, None]
                    starts[sel] += ext_b[sel]
                else:
                    sel = fwd & grow[:, None]
                    starts[sel] -= ext_b[sel]
                lengths += ext
            active = full
    out = MatchList(starts, lengths)
    return out.dedup() if dedup else out



# ---------------------------------------------------------------------------
# Host seed-group path over sorted mer lists (the disk-cache search of
# progressiveMauve and repeatoire's seeding): one device sort, then host
# NumPy, as in the JAX package.
# ---------------------------------------------------------------------------


def _device_sorted_entries(smls: Sequence[SortedMerList], device="cuda"):
    """Concatenate per-genome SMLs and sort them by (mer, genome, position)
    on `device`; host (mer int64, seq int32, pos int32, strand int32).

    Unlike _global_sort, this cannot rely on the input order: each SML is
    sorted by its full key, strand bit in the LSB, so within one mer a
    genome's strand-0 entries come before its strand-1 entries whatever
    their positions.  A sort by (genome, position) first, then a stable sort
    by mer, gives the full order.  The JAX package's bucket-ladder padding
    only bounded its compiles and is dropped."""
    if not smls or sum(len(s.keys) for s in smls) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    keys = torch.from_numpy(np.concatenate([s.keys for s in smls])).to(device)
    pos = torch.from_numpy(
        np.concatenate([s.positions for s in smls]).astype(np.int32)
    ).to(device)
    seq = torch.cat([
        torch.full((len(s.keys),), i, dtype=torch.int32, device=keys.device)
        for i, s in enumerate(smls)
    ])
    # (genome, position) pairs are distinct: this sort needs no stability
    order = torch.sort((seq.to(torch.int64) << 32) | pos.to(torch.int64)).indices
    mer = keys[order] >> 1
    mer_s, o2 = torch.sort(mer, stable=True)
    order = order[o2]
    return (
        mer_s.cpu().numpy(),
        seq[order].cpu().numpy(),
        pos[order].cpu().numpy(),
        (keys[order] & 1).to(torch.int32).cpu().numpy(),
    )


@dataclasses.dataclass
class SeedGroups:
    """Sorted seed-group representation (ragged, host side)."""

    mer: np.ndarray       # int64 [N] sorted strand-free mers
    seq: np.ndarray       # int32 [N]
    pos: np.ndarray       # int32 [N] 0-based window starts
    strand: np.ndarray    # int32 [N] canonical-strand bit per window
    seg_id: np.ndarray    # int64 [N] group index
    occ_unique: np.ndarray  # bool [N] occurrence is unique within its genome
    n_segs: int


def build_seed_groups(smls: Sequence[SortedMerList], device="cuda") -> SeedGroups:
    mer, seq, pos, strand = _device_sorted_entries(smls, device)
    n = len(mer)
    if n == 0:
        return SeedGroups(mer, seq, pos, strand, np.zeros(0, np.int64), np.zeros(0, bool), 0)
    new_seg = np.empty(n, dtype=bool)
    new_seg[0] = True
    np.not_equal(mer[1:], mer[:-1], out=new_seg[1:])
    seg_id = np.cumsum(new_seg) - 1
    same_ms = np.zeros(n, dtype=bool)
    same_ms[1:] = (~new_seg[1:]) & (seq[1:] == seq[:-1])
    occ_unique = ~same_ms
    occ_unique[:-1] &= ~same_ms[1:]
    return SeedGroups(mer, seq, pos, strand, seg_id, occ_unique, int(seg_id[-1]) + 1)


def seed_matches_from_groups(
    groups: SeedGroups,
    n_seqs: int,
    seed_length: int,
    unique: bool = True,
    min_multi: int = 2,
    max_multi: Optional[int] = None,
    seq_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense seed-match rows from seed groups, unique-MUM semantics: a
    genome participates in a group's match only if its occurrence count in
    the group is exactly one (UniqueMatchFinder,
    src/UniqueMatchFinder.cpp:36-60).  Groups with fewer than min_multi
    participating genomes are dropped; max_multi bounds the multiplicity
    (rmin/rmax of SeedMatchEnumerator::FindMatches,
    src/SeedMatchEnumerator.h:19-23).

    Returns (pos0 int64 [m, n_seqs] 0-based window starts, -1 = absent,
    rel_strand int8 [m, n_seqs], ref_seq int32 [m]).  Repeat mode is
    repeat_matches_from_groups."""
    if not unique:
        raise ValueError("use repeat_matches_from_groups for repeat mode")
    g = groups
    comp = g.occ_unique.copy()
    if seq_mask is not None:
        comp &= np.asarray(seq_mask, dtype=bool)[g.seq]
    counts = np.bincount(g.seg_id[comp], minlength=g.n_segs)
    ok_seg = counts >= min_multi
    if max_multi is not None:
        ok_seg &= counts <= max_multi
    keep = comp & ok_seg[g.seg_id]
    if not keep.any():
        return (
            np.full((0, n_seqs), -1, np.int64),
            np.zeros((0, n_seqs), np.int8),
            np.zeros(0, np.int32),
        )
    seg_sel = np.unique(g.seg_id[keep])
    remap = np.full(g.n_segs, -1, np.int64)
    remap[seg_sel] = np.arange(len(seg_sel))
    rows = remap[g.seg_id[keep]]
    cols = g.seq[keep]
    m = len(seg_sel)
    pos0 = np.full((m, n_seqs), -1, np.int64)
    strand = np.zeros((m, n_seqs), np.int8)
    pos0[rows, cols] = g.pos[keep]
    strand[rows, cols] = g.strand[keep]
    # reference component: first participating genome; rel strand by parity
    present = pos0 >= 0
    ref_seq = np.argmax(present, axis=1).astype(np.int32)
    ref_strand = strand[np.arange(m), ref_seq]
    rel_strand = np.where(present, strand ^ ref_strand[:, None], 0).astype(np.int8)
    return pos0, rel_strand, ref_seq


def merge_collinear_runs(
    pos0: np.ndarray, rel_strand: np.ndarray, ref_seq: np.ndarray, seed_length: int
) -> MatchList:
    """Merge diagonal-consistent consecutive seed windows into single
    matches: consecutive reference positions with identical component
    structure (same genomes, relative strands and diagonal invariants) form
    one match.  The invariant of component j at reference window position
    p0 is pos_j - p0 for relatively-forward components and pos_j + p0 for
    relatively-reverse ones (whose window slides left as the reference
    window slides right)."""
    m, n_seqs = pos0.shape
    if m == 0:
        return MatchList.empty(n_seqs)
    present = pos0 >= 0
    p0 = pos0[np.arange(m), ref_seq].astype(np.int64)
    inv = np.where(
        present,
        np.where(rel_strand == 0, pos0 - p0[:, None], pos0 + p0[:, None]),
        _INT64_MAX,
    )
    sig_strand = np.where(present, rel_strand, -1)
    # lexsort's LAST key is primary: rows order by the signature columns,
    # then p0 within a signature
    sort_keys = [p0]
    for j in range(n_seqs - 1, -1, -1):
        sort_keys.append(sig_strand[:, j])
        sort_keys.append(inv[:, j])
    order = np.lexsort(sort_keys)
    inv_s, strand_s, p0_s = inv[order], sig_strand[order], p0[order]
    same_sig = np.all(inv_s[1:] == inv_s[:-1], axis=1) & np.all(
        strand_s[1:] == strand_s[:-1], axis=1
    )
    run_continue = same_sig & (p0_s[1:] == p0_s[:-1] + 1)
    run_start = np.concatenate([[True], ~run_continue])
    first_idx = np.nonzero(run_start)[0]
    run_len = np.diff(np.concatenate([first_idx, [m]]))
    p0_min = p0_s[first_idx]
    p0_max = p0_min + run_len - 1
    inv_r = inv_s[first_idx]
    strand_r = strand_s[first_idx]
    lengths = (p0_max - p0_min) + seed_length
    present_r = strand_r >= 0
    left0 = np.where(
        strand_r == 0,
        inv_r + p0_min[:, None],
        inv_r - p0_max[:, None],
    )
    starts = np.where(
        present_r,
        np.where(strand_r == 0, left0 + 1, -(left0 + 1)),
        NO_MATCH,
    )
    return MatchList(starts, lengths)


def find_multi_mums(
    genomes: Sequence[Genome],
    smls: Sequence[SortedMerList],
    min_multi: int = 2,
    max_multi: Optional[int] = None,
    nway: bool = False,
    seq_mask: Optional[np.ndarray] = None,
    extend: bool = True,
    device="cuda",
) -> MatchList:
    """Unique multi-MUM search over sorted mer lists (the MaskedMemHash /
    UniqueMatchFinder pipeline, src/mauveAligner.cpp:523-590)."""
    seed_length = smls[0].seed_length if smls else 0
    groups = build_seed_groups(smls, device)
    pos0, rel_strand, ref_seq = seed_matches_from_groups(
        groups,
        n_seqs=len(genomes),
        seed_length=seed_length,
        unique=True,
        min_multi=min_multi,
        max_multi=max_multi,
        seq_mask=seq_mask,
    )
    ml = merge_collinear_runs(pos0, rel_strand, ref_seq, seed_length)
    if extend and len(ml):
        ml = extend_matches_maximal(ml, [g.codes for g in genomes])
    if nway:
        ml = ml.multiplicity_filter(len(genomes))
    return ml


def repeat_matches_from_groups(
    groups: SeedGroups,
    seed_length: int,
    min_multi: int = 2,
    max_multi: int = 1000,
    only_direct: bool = False,
) -> MatchList:
    """Seed matches for repeat finding: every occurrence participates
    (RepeatHash / SeedMatchEnumerator semantics,
    src/SeedMatchEnumerator.h:59-141, incl. the only_direct projection to
    forward-strand components).  Components of one match sit left-compacted
    in a dense [m, width] table; the first entry of each group (in
    (mer, genome, position) order) is the reference component."""
    g = groups
    if len(g.mer) == 0:
        return MatchList.empty(1)
    counts = np.bincount(g.seg_id, minlength=g.n_segs)
    ok = (counts >= min_multi) & (counts <= max_multi)
    keep = ok[g.seg_id]
    if not keep.any():
        return MatchList.empty(int(counts.max(initial=1)))
    seg = g.seg_id[keep]
    pos = g.pos[keep].astype(np.int64)
    strand = g.strand[keep]
    seg_sel, seg_start = np.unique(seg, return_index=True)
    m = len(seg_sel)
    remap = np.full(g.n_segs, -1, np.int64)
    remap[seg_sel] = np.arange(m)
    rows = remap[seg]
    ref_strand = strand[seg_start[rows]]
    rel = strand ^ ref_strand
    signed = np.where(rel == 0, pos + 1, -(pos + 1))
    if only_direct:
        # forward-strand components only (src/SeedMatchEnumerator.h:88-117)
        keep_comp = rel == 0
        rows, signed = rows[keep_comp], signed[keep_comp]
    # left-compact components into dense columns per row
    if len(rows):
        order = np.argsort(rows, kind="stable")
        rows, signed = rows[order], signed[order]
        row_first = np.zeros(len(rows), np.int64)
        is_first = np.concatenate([[True], rows[1:] != rows[:-1]])
        idx_first = np.nonzero(is_first)[0]
        row_first[idx_first] = idx_first
        np.maximum.accumulate(row_first, out=row_first)
        cols = np.arange(len(rows)) - row_first
        width = int(cols.max()) + 1
    else:
        cols = rows
        width = 1
    starts = np.zeros((m, max(width, 1)), np.int64)
    starts[rows, cols] = signed
    lengths = np.full(m, seed_length, np.int64)
    ml = MatchList(starts, lengths)
    return ml.select(ml.multiplicity() >= min_multi)

# ---------------------------------------------------------------------------
# Batched multi-gap recursion search: all gaps of a recursion round are
# searched in one pass.  Every gap's per-genome regions are laid out back to
# back in a flat coordinate space with one CODE_N separator after each
# region (separators make boundary-crossing seed windows invalid and stop
# base-level extension at region edges); each window's canonical key is
# tagged with its gap id above the mer bits, so the global sort groups
# (gap, mer) and runs never span gaps.
# ---------------------------------------------------------------------------


def _gap_flat_mer_entries(
    codes_flat: torch.Tensor,  # uint8 [n_seqs * cpad] genome codes, CODE_N padded
    specs: torch.Tensor,       # int64 [R, 5] (left0, len, strand, seq, gap)
    offsets: Tuple[int, ...],
    pattern_len: int,
    tag_shift: int,
    F: int,
    n_seqs: int,
):
    """Flat multi-gap window extraction + mer packing + gap tagging.

    Region r occupies flat slots [fs[r], fs[r] + len_r) followed by one
    CODE_N separator slot; reverse-strand regions are extracted
    reverse-complemented so every flat region reads relatively forward.
    Returns (tagged keys int64 [F - L + 1], seq ids int32, flat positions
    int32) for device_mum_candidates."""
    dev = codes_flat.device
    cpad = codes_flat.shape[0] // n_seqs
    R = specs.shape[0]
    left0, ln, strand, seq, gap = (specs[:, c] for c in range(5))
    fs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(ln + 1, 0)])
    T = fs[R]
    f = torch.arange(F, dtype=torch.int64, device=dev)
    row = (torch.searchsorted(fs, f, right=True) - 1).clamp(0, R - 1)
    within = f - fs[row]
    pad_cell = (within >= ln[row]) | (f >= T)
    fwd = strand[row] > 0
    idx = left0[row] + torch.where(fwd, within, ln[row] - 1 - within)
    idx = idx.clamp(0, cpad - 1)
    base = codes_flat[seq[row] * cpad + idx].to(torch.int64)
    base = torch.where(fwd, base, torch.where(base < CODE_N, 3 - base, base))
    base = torch.where(pad_cell, CODE_N, base)
    keys = merops.pack_canonical_mers(base, offsets, pattern_len)
    npos = keys.shape[0]
    # spaced seeds have don't-care slots: a window can straddle the CODE_N
    # separator without reading it, mixing content from two regions.  Any
    # window whose first and last cells fall in different rows is invalid.
    end_row = row[torch.arange(npos, device=dev) + (pattern_len - 1)]
    keys = torch.where(end_row != row[:npos], INVALID_KEY, keys)
    gid = gap[row[:npos]]
    keys = torch.where(keys == INVALID_KEY, INVALID_KEY, keys | (gid << tag_shift))
    return keys, seq[row[:npos]].to(torch.int32), f[:npos].to(torch.int32)


def _gap_spec_rows(gap_specs: np.ndarray, n_seqs: int) -> Tuple[np.ndarray, np.ndarray]:
    """[G, n, 3] (left, right, strand) 1-based inclusive -> flat spec rows
    [R, 5] int32 (left0, len, strand, seq, gap) and the host fs offsets."""
    G = gap_specs.shape[0]
    left = gap_specs[:, :, 0]
    right = gap_specs[:, :, 1]
    strand = gap_specs[:, :, 2]
    ln = np.maximum(0, right - left + 1)
    R = G * n_seqs
    rows = np.zeros((R, 5), np.int32)
    rows[:, 0] = np.maximum(0, left - 1).reshape(-1)
    rows[:, 1] = ln.reshape(-1)
    rows[:, 2] = np.where(strand.reshape(-1) == 0, 1, strand.reshape(-1))
    rows[:, 3] = np.tile(np.arange(n_seqs, dtype=np.int32), G)
    rows[:, 4] = np.repeat(np.arange(G, dtype=np.int32), n_seqs)
    fs = np.concatenate([[0], np.cumsum(rows[:, 1].astype(np.int64) + 1)])
    return rows, fs


def _stacked_codes_device(genomes: Sequence[Genome], pattern_len: int, device):
    """Every genome's codes in one flat uint8 device tensor [n * cpad],
    CODE_N padded (cached on the first genome for reuse across rounds)."""
    cpad = max(len(g) for g in genomes) + pattern_len
    key = (tuple(id(g) for g in genomes), cpad, str(device))
    holder = genomes[0]
    cached = getattr(holder, "_flat_stack_cache", None)
    # the cache value holds strong references to the genomes so an id() in
    # the key can never belong to a freed-and-reallocated object
    if cached is not None and cached[0] == key:
        return cached[1], cpad
    flat = np.full(len(genomes) * cpad, CODE_N, np.uint8)
    for i, g in enumerate(genomes):
        flat[i * cpad : i * cpad + len(g)] = g.codes
    flat_dev = torch.from_numpy(flat).to(device)
    holder._flat_stack_cache = (key, flat_dev, tuple(genomes))
    return flat_dev, cpad


def _flat_codes_host(
    genomes: Sequence[Genome], rows: np.ndarray, fs: np.ndarray
) -> np.ndarray:
    """Host mirror of the flat region layout (for base-level extension)."""
    total = int(fs[-1])
    flat = np.full(total, CODE_N, np.uint8)
    for r in range(rows.shape[0]):
        l0, lnr, st, s, _ = (int(v) for v in rows[r])
        if lnr <= 0:
            continue
        seg = genomes[s].codes[l0 : l0 + lnr]
        if st < 0:
            seg = seg[::-1]
            seg = np.where(seg < CODE_N, 3 - seg, seg).astype(np.uint8)
        flat[fs[r] : fs[r] + lnr] = seg
    return flat


def find_gap_mums_batched(
    genomes: Sequence[Genome],
    gap_specs: np.ndarray,  # int64 [G, n, 3] (left, right, strand) 1-based
    seed,
    device,
    extend: bool = True,
) -> Tuple[np.ndarray, MatchList]:
    """Unique multi-MUM search over many inter-anchor gaps in one pass on
    `device`.  Returns (gap_ids int64 [m], MatchList in genome coordinates);
    rows keep >= 2 components (callers apply their multiplicity policy)."""
    n = len(genomes)
    G = gap_specs.shape[0]
    if G == 0:
        return np.zeros(0, np.int64), MatchList.empty(n)
    tag_shift = 2 * seed.weight + 1
    assert (G << tag_shift) < (1 << 62), "gap tag would overflow the key space"
    rows, fs = _gap_spec_rows(np.asarray(gap_specs, np.int64), n)
    R = rows.shape[0]
    F = int(fs[-1]) + seed.length
    codes_flat, _ = _stacked_codes_device(genomes, seed.length, device)
    offsets = tuple(int(o) for o in seed.offsets)
    keys, seq_ids, pos = _gap_flat_mer_entries(
        codes_flat, torch.from_numpy(rows.astype(np.int64)).to(device),
        offsets, seed.length, tag_shift, F, n,
    )
    N = int(keys.shape[0])
    timing.GLOBAL.add("k2_sort_entries", float(N))
    mask = torch.ones(n, dtype=torch.int32, device=keys.device)
    cap = max(1 << 14, N >> 3)
    t0 = time.perf_counter()
    ml = _candidates_with_retry(keys, seq_ids, pos, mask, n, cap, 2, seed.length)
    timing.GLOBAL.add("recursion_kernel_s", time.perf_counter() - t0)
    if len(ml) == 0:
        return np.zeros(0, np.int64), MatchList.empty(n)
    if extend:
        t0 = time.perf_counter()
        flat_host = _flat_codes_host(genomes, rows, fs)
        ml = extend_matches_maximal(ml, [flat_host] * n)
        timing.GLOBAL.add("recursion_extend_s", time.perf_counter() - t0)
    # map flat coordinates back to (gap, genome coordinates)
    starts = ml.starts
    lengths = ml.lengths
    pres = starts != NO_MATCH
    flatpos = np.where(pres, np.abs(starts) - 1, 0)
    rowr = (
        np.searchsorted(fs, flatpos.reshape(-1), side="right") - 1
    ).reshape(starts.shape)
    specsm = rows[np.clip(rowr, 0, R - 1)]  # [m, n, 5]
    gapm = specsm[:, :, 4].astype(np.int64)
    seqm = specsm[:, :, 3]
    cols = np.broadcast_to(np.arange(n, dtype=np.int32), starts.shape)
    gap_ref = gapm[np.arange(len(ml)), np.argmax(pres, axis=1)]
    consistent = np.all(
        (~pres) | ((seqm == cols) & (gapm == gap_ref[:, None])), axis=1
    )
    l0 = specsm[:, :, 0].astype(np.int64)
    lnr = specsm[:, :, 1].astype(np.int64)
    st = specsm[:, :, 2].astype(np.int64)
    within = flatpos - fs[np.clip(rowr, 0, R - 1)]
    Lm = lengths[:, None]
    g_left0 = np.where(st > 0, l0 + within, l0 + lnr - within - Lm)
    g_fwd = np.where(st > 0, starts > 0, starts < 0)
    new_starts = np.where(g_fwd, g_left0 + 1, -(g_left0 + 1))
    new_starts[~pres] = NO_MATCH
    out = MatchList(new_starts[consistent], lengths[consistent])
    return gap_ref[consistent], out
