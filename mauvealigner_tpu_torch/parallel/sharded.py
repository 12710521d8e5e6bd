"""Sharded device programs over a Mesh of torch devices.

Port of mauvealigner_tpu/parallel/sharded.py.  torch has no shard_map: a
Mesh here is a tuple of torch devices, one per shard, and optionally a
torch.distributed process group.  Each program's per-shard body is written
once, as a function of the shard index d (the JAX package's
`jax.lax.axis_index`); a host loop runs it for every shard this process
holds (`Mesh.local_shards()`), and `Mesh.all_to_all` / `Mesh.gather` stand
in for the collectives between bodies (multihost.scatter_global and
fetch_replicated move rows in and tables out):

  * without a group, one process drives every shard; shard d's tensors
    live on devices[d], and devices may repeat (four shards on cuda:0);
  * with a group, each rank holds one shard on its own device, and the
    collectives are torch.distributed calls.

Strategy (as in the JAX package): genomes are replicated; the *work* is
sharded.
  * `sharded_pack_sort`: the distributed SML build (window space
    block-sharded, range-partitioned by canonical key, sorted per partition);
  * `sharded_mum_candidate_tables` / `find_multi_mums_sharded`: the N-way
    unique multi-MUM search as a two-phase all-to-all;
  * `sharded_pair_mum_tables` / `find_pair_mums_sharded` /
    `sort_contigs_sharded`: the draft workflow's per-pair searches split on
    the pair axis;
  * `sharded_hmm_posteriors`: K4 forward/backward over a split batch.
The JAX package's test harnesses `sharded_gotoh_scores` and
`multichip_pipeline_step` have no counterpart: the model path shards DP
batches through parallel/context.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.ops.merops import INVALID_KEY


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One shard per entry of `devices`.  Without a group every shard is
    local; with a torch.distributed group shard d is rank d's, on
    devices[d]."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.group is not None:
            import torch.distributed as dist

            if dist.get_world_size(self.group) != len(self.devices):
                raise ValueError(
                    f"{len(self.devices)} devices for a group of "
                    f"{dist.get_world_size(self.group)} ranks"
                )

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> List[int]:
        """The shard indices this process runs."""
        if self.group is None:
            return list(range(self.size))
        import torch.distributed as dist

        return [dist.get_rank(self.group)]

    def all_to_all(self, sends: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """sends[d]: shard d's [D, C] send buffer (row e goes to shard e), on
        devices[d].  Returns recv[d]: [D, C] on devices[d], row s = what
        shard s sent to d."""
        if self.group is None:
            return {
                d: torch.stack([sends[s][d].to(self.devices[d]) for s in range(self.size)])
                for d in sends
            }
        import torch.distributed as dist

        (d, x), = sends.items()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return {d: out}

    def gather(self, local: Dict[int, object]) -> Dict[int, object]:
        """Every shard's host object (numpy arrays of any shape) on every
        process, keyed by shard: under a group an all_gather of the
        pickled objects."""
        if self.group is None:
            return dict(local)
        import torch.distributed as dist

        out: list = [None] * self.size
        dist.all_gather_object(out, local, group=self.group)
        merged: Dict[int, object] = {}
        for part in out:
            merged.update(part)
        return merged


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A one-process mesh: on cuda, one shard per visible GPU (the first
    n_devices of them; more than there are raises, as the JAX package's
    make_mesh does); on cpu, n_devices logical shards on the CPU (the
    counterpart of XLA's forced host device count)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"no mesh for device {device!r}")
    have = torch.cuda.device_count()
    n = n_devices or have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _dispatch(part: torch.Tensor, D: int, C: int, arrays_with_fill):
    """Scatter entries into [D*C]-slot send buffers by destination `part`
    (== D drops the entry).  Returns ([D*C] buffers, dropped count as an
    int32 scalar tensor); the per-destination slot assignment is
    order-stable (arrival order), so results are deterministic."""
    n = part.shape[0]
    dev = part.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    part_s, src = torch.sort(part, stable=True)
    newg = torch.ones(n, dtype=torch.bool, device=dev)
    newg[1:] = part_s[1:] != part_s[:-1]
    gstart = torch.where(newg, iota, 0).cummax(0).values
    slot = iota - gstart
    keep = (part_s < D) & (slot < C)
    addr = torch.where(keep, part_s.to(torch.int64) * C + slot, D * C)
    outs = []
    for arr, fill in arrays_with_fill:
        # one spare slot takes every dropped entry; it is sliced off
        buf = torch.full((D * C + 1,), fill, dtype=arr.dtype, device=dev)
        buf[addr] = arr[src]
        outs.append(buf[: D * C])
    dropped = ((part < D).sum() - keep.sum()).to(torch.int32)
    return outs, dropped


def _canonical_splitters(weight: int, D: int) -> np.ndarray:
    """Range splitters over canonical-mer KEY space that balance load.

    Canonical mers are min(fwd, rc) of ~uniform 2w-bit values, so their CDF
    is P(c < q*4^w) = 1-(1-q)^2; equal-mass boundaries are
    q_i = 1 - sqrt(1 - i/D).  Keys carry the strand bit below the mer, so
    splitters shift left one bit."""
    i = np.arange(D, dtype=np.float64)
    q = 1.0 - np.sqrt(1.0 - i / D)
    mer_space = float(4 ** weight)
    return (np.floor(q * mer_space).astype(np.int64) << 1)


def _sort_key_pos_full(keys: torch.Tensor, pos: torch.Tensor):
    """Sort (key, position) pairs by key, then position, whatever the input
    order (received partitions interleave sources and fill slots)."""
    o = torch.sort(pos, stable=True).indices
    o = o[torch.sort(keys[o], stable=True).indices]
    return keys[o], pos[o]


def sharded_pack_sort(
    codes,
    offsets: Tuple[int, ...],
    pattern_len: int,
    mesh: Mesh,
    capacity_factor: float = 1.6,
):
    """Distributed SML build: block-shard the window space, pack locally,
    range-partition by canonical-key value with an all-to-all, and sort each
    partition locally.

    codes: integer codes (numpy or a tensor), replicated.  Returns (keys,
    pos, dropped): keys int64 [C] and pos int32 [C] per local shard (a dict
    by shard), partition d sorted ascending by (key, position) with
    INVALID_KEY padding at its tail, so the shards' concatenation in shard
    order is globally ordered once INVALID entries are dropped; dropped is
    the total count of entries lost to partition overflow (retry with a
    larger factor when > 0)."""
    D = mesh.size
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    n_pos = int(codes.shape[0]) - pattern_len + 1
    block = -(-n_pos // D)
    halo = pattern_len - 1
    C = int(np.ceil(block * capacity_factor / D)) * D
    Cd = C // D
    # pad codes so every shard's window block is in range
    need = block * D + halo
    if codes.shape[0] < need:
        pad = torch.full((need - codes.shape[0],), 4, dtype=codes.dtype, device=codes.device)
        codes = torch.cat([codes, pad])
    splitters = torch.from_numpy(_canonical_splitters(len(offsets), D))

    def send(d):
        dev = mesh.devices[d]
        start = d * block
        chunk = codes[start : start + block + halo].to(dev)
        keys = merops.pack_canonical_mers(chunk, offsets, pattern_len)
        pos = start + torch.arange(block, dtype=torch.int32, device=dev)
        valid = keys != INVALID_KEY
        part = torch.searchsorted(splitters.to(dev), keys, right=True).to(torch.int32) - 1
        part = torch.where(valid, part.clamp(0, D - 1), D)
        (sk, sp), dropped = _dispatch(part, D, Cd, [(keys, INVALID_KEY), (pos, 0)])
        return sk.reshape(D, Cd), sp.reshape(D, Cd), dropped

    from mauvealigner_tpu_torch.parallel import multihost

    sent = {d: send(d) for d in mesh.local_shards()}
    rk = mesh.all_to_all({d: s[0] for d, s in sent.items()})
    rp = mesh.all_to_all({d: s[1] for d, s in sent.items()})
    keys_out, pos_out = {}, {}
    for d in sent:
        keys_out[d], pos_out[d] = _sort_key_pos_full(rk[d].reshape(-1), rp[d].reshape(-1))
    dropped = int(multihost.fetch_replicated({d: s[2] for d, s in sent.items()}, mesh).sum())
    return keys_out, pos_out, dropped


def sharded_mum_candidate_tables(
    keys: Dict[int, torch.Tensor],       # int64 [N/D] per local shard (scatter_global)
    seq_ids: Dict[int, torch.Tensor],    # int32 [N/D]
    positions: Dict[int, torch.Tensor],  # int32 [N/D]
    n_seqs: int,
    cap_local: int,          # candidate-run capacity PER SHARD
    C1: int,                 # phase-1 per-(src,dst) slot capacity
    C2: int,                 # phase-2 per-(src,dst) slot capacity
    mesh: Mesh,
    min_multi: int = 2,
):
    """The flagship N-way anchor search under a mesh: unique multi-MUM
    candidate runs with no replicated re-sort; each shard sorts only its
    partition (~N/D entries per phase).

    Two all-to-all phases:
      1. entries route to hash(mer): seed grouping, per-genome uniqueness,
         reference selection and the 64-bit group signature are local-exact
         because every occurrence of a mer lands on one shard;
      2. kept entries route to hash(signature): all windows of one diagonal
         run share the signature by construction, so run merging is
         local-exact on the receiving shard.

    Returns (tables, dropped), each a dict by local shard: shard d's packed
    candidate table int32 [cap_local+1, n_seqs+2] over its signature
    partition, and its int32 count of entries lost to slot-capacity
    overflow (any nonzero count means the caller must retry with larger
    capacities)."""
    from mauvealigner_tpu_torch.ops import matchops

    D = mesh.size

    def phase1(d):
        k, s, p = keys[d], seq_ids[d], positions[d]
        mer = k >> 1
        valid = k != INVALID_KEY
        # `%` is Python's modulo (non-negative for a positive divisor), which
        # keeps the partition uniform for any mesh size
        h1 = matchops._mix64(mer + 3, matchops._MIX_C2)
        part1 = torch.where(valid, (h1 % D).to(torch.int32), D)
        sp64 = (s.to(torch.int64) << 32) | (p.to(torch.int64) & 0xFFFFFFFF)
        (sk, ssp), drop1 = _dispatch(part1, D, C1, [(k, INVALID_KEY), (sp64, 0)])
        return sk.reshape(D, C1), ssp.reshape(D, C1), drop1

    def phase2(d, rk, rsp):
        dev = mesh.devices[d]
        rs = (rsp >> 32).to(torch.int32)
        rp = (rsp & 0xFFFFFFFF).to(torch.int32)
        mask = torch.ones(n_seqs, dtype=torch.int32, device=dev)
        # local grouping/signature over this shard's mer partition; the
        # received entries interleave D sources, so sort in full
        (_, kept, _, rep_sig, seq2, _, spos2, ref_pos) = matchops._sig_phase(
            rk, rs, rp, mask, n_seqs, min_multi, full_sort=True
        )
        h2 = matchops._mix64(rep_sig + 5, matchops._MIX_C1)
        part2 = torch.where(kept, (h2 % D).to(torch.int32), D)
        bufs, drop2 = _dispatch(
            part2, D, C2,
            [(rep_sig, 0), (ref_pos, 0), (spos2, 0), (seq2, -1)],
        )
        return [b.reshape(D, C2) for b in bufs], drop2

    local = mesh.local_shards()
    p1 = {d: phase1(d) for d in local}
    rk = mesh.all_to_all({d: x[0] for d, x in p1.items()})
    rsp = mesh.all_to_all({d: x[1] for d, x in p1.items()})
    p2 = {d: phase2(d, rk[d].reshape(-1), rsp[d].reshape(-1)) for d in local}
    recv = [mesh.all_to_all({d: x[0][i] for d, x in p2.items()}) for i in range(4)]
    tables = {
        d: matchops.mum_runs_from_sig_entries(
            recv[0][d].reshape(-1), recv[1][d].reshape(-1), recv[3][d].reshape(-1),
            recv[2][d].reshape(-1), n_seqs, cap_local,
        )
        for d in local
    }
    dropped = {d: p1[d][2] + p2[d][1] for d in local}
    return tables, dropped


def _head_rows(mesh: Mesh, tabs: Dict[int, torch.Tensor], cap: int) -> np.ndarray:
    """Every shard's table rows up to its run count, stacked on the host:
    a head slice of 4097 rows first (row 0 carries the run count), taller
    only when some shard's count needs it."""
    from mauvealigner_tpu_torch.parallel import multihost

    first = min(1 + (1 << 12), cap + 1)
    head = multihost.fetch_replicated({d: t[..., :first, :] for d, t in tabs.items()}, mesh)
    need = int(head[..., 0, 0].max(initial=0)) + 1
    if first < need <= cap + 1:
        head = multihost.fetch_replicated({d: t[..., :need, :] for d, t in tabs.items()}, mesh)
    return head


def find_multi_mums_sharded(
    genomes,
    smls_dev,
    mesh: Mesh,
    min_multi: int = 2,
    nway: bool = False,
    extend: bool = True,
    seed_length: int = 0,
):
    """Mesh-sharded drop-in for matchops.find_multi_mums_device.

    Hash partitioning by signature keeps diagonal runs whole, but a run
    whose windows span a group-signature change can fragment exactly as on
    one device; base-level extension + dedup normalizes both paths to the
    same maximal matches.  Output rows are sorted canonically, so the result
    is independent of the mesh size.

    Genomes are replicated on every process: each builds the same entry
    arrays and keeps its own row block (multihost.scatter_global), and the
    compact candidate tables gather back to every process, so all processes
    hold the same MatchList."""
    from mauvealigner_tpu_torch.core.match import MatchList
    from mauvealigner_tpu_torch.ops import matchops
    from mauvealigner_tpu_torch.parallel import multihost
    from mauvealigner_tpu_torch.utils import timing

    n_seqs = len(genomes)
    keys, seq_ids, pos = matchops._concat_device_smls(smls_dev)
    N = int(keys.shape[0])
    D = mesh.size
    if N % D:  # non-power-of-two meshes: pad the entry rows to divide
        padn = (-N) % D
        dev = keys.device
        keys = torch.cat([keys, torch.full((padn,), INVALID_KEY, dtype=torch.int64, device=dev)])
        seq_ids = torch.cat([seq_ids, torch.zeros(padn, dtype=torch.int32, device=dev)])
        pos = torch.cat([pos, torch.zeros(padn, dtype=torch.int32, device=dev)])
        N += padn
    # each process keeps its shards' row blocks (under a process group, the
    # multi-process branch: host-replicated entries scattered into the mesh)
    keys, seq_ids, pos = (multihost.scatter_global(x, mesh) for x in (keys, seq_ids, pos))
    cf = 1.7
    cap_local = max(1 << 12, (N >> 3) // D)
    while True:
        C1 = -(-int(N * cf) // (D * D))
        C1 = (C1 + 7) & ~7
        C2 = (int(C1 * cf) + 7) & ~7
        tabs, dropped = sharded_mum_candidate_tables(
            keys, seq_ids, pos, n_seqs, cap_local, C1, C2, mesh, min_multi
        )
        if int(multihost.fetch_replicated(dropped, mesh).sum()) > 0:
            cf *= 2.0
            continue
        head = _head_rows(mesh, tabs, cap_local)
        n_runs = head[:, 0, 0]
        if (n_runs > cap_local).any():
            cap_local = 1 << int(int(n_runs.max()) - 1).bit_length()
            continue
        # record per-shard work once, for the capacities that succeeded
        timing.GLOBAL.add("k2_sharded_entries_per_device", float(N // D + D * C1 + D * C2))
        break
    parts = [matchops.decode_mum_table(head[d], n_seqs, cap_local, seed_length) for d in range(D)]
    ml = parts[0]
    for x in parts[1:]:
        ml = ml.concat(x)
    if extend and len(ml):
        ml = matchops.extend_matches_maximal(ml, [g.codes for g in genomes])
    elif len(ml):
        ml = ml.dedup()
    if nway:
        ml = ml.multiplicity_filter(n_seqs)
    if len(ml):
        order = np.lexsort(tuple(ml.starts[:, j] for j in range(n_seqs - 1, -1, -1)))
        ml = ml.select(order)
    return ml if len(ml) else MatchList.empty(n_seqs)


def sharded_hmm_posteriors(
    log_emit,    # [B, T, S]
    log_trans,   # [S, S] (replicated)
    log_init,    # [S] (replicated)
    lengths,     # [B]
    mesh: Mesh,
) -> np.ndarray:
    """Batch-sharded K4 forward/backward: each shard decodes its slice of
    the batch with the log-depth associative scan; returns the posteriors
    [B, T, S] on the host.

    A harness for the mesh tests: the model path decodes through
    ops.hmm.bucketed_decode and analysis.backbone under the ambient mesh."""
    from mauvealigner_tpu_torch.ops import hmm as hmm_ops
    from mauvealigner_tpu_torch.parallel import context

    def local(le, lens, lt, li, device):
        return hmm_ops.forward_backward(le, lt, li, lens)

    return context.shard_batched_call(
        local, [torch.as_tensor(log_emit), torch.as_tensor(lengths)],
        (torch.as_tensor(log_trans), torch.as_tensor(log_init)), mesh=mesh,
    )


def sharded_pair_mum_tables(
    keys: Dict[int, torch.Tensor],     # int64 [P/D, N] per local shard
    seq_ids: Dict[int, torch.Tensor],  # int32 [P/D, N]
    pos: Dict[int, torch.Tensor],      # int32 [P/D, N]
    n_seqs: int,
    cap: int,
    mesh: Mesh,
    min_multi: int = 2,
) -> Dict[int, torch.Tensor]:
    """K2 unique-MUM candidate search for many independent genome pairs,
    split on the pair axis: each shard runs the full candidate search on
    each of its pair rows.  Returns, per local shard, its tables stacked:
    int32 [P/D, cap+1, n_seqs+2].

    This is the pod-level axis of the draft workflow (reference analog:
    per-process match partitioning via --match-log / --realign-lcb,
    src/mauveAligner.cpp:130-131,533-589)."""
    from mauvealigner_tpu_torch.ops import matchops

    def local(d):
        mask = torch.ones(n_seqs, dtype=torch.int32, device=mesh.devices[d])
        k, s, p = keys[d], seq_ids[d], pos[d]
        return torch.stack([
            matchops.device_mum_candidates(k[r], s[r], p[r], mask, n_seqs, cap, min_multi)
            for r in range(k.shape[0])
        ])

    return {d: local(d) for d in mesh.local_shards()}


def find_pair_mums_sharded(
    ref,
    drafts,
    seed,
    mesh: Mesh,
    extend: bool = True,
    device=None,
):
    """Reference-vs-draft unique MUMs for every draft, pair-sharded over the
    mesh.  Returns one 2-sequence MatchList per draft (row 0 = ref).

    Per-pair mer lists build on `device` (default: the first local shard's);
    every pair's entries pad with inert INVALID entries to the longest
    pair's, and the pair count pads to the mesh size with all-INVALID rows
    (empty tables, never decoded); the shards split the pair rows; the run
    capacity doubles until no table overflows; each table decodes with the
    single-device decode."""
    from mauvealigner_tpu_torch.core.sml import build_mer_list_device
    from mauvealigner_tpu_torch.ops import matchops
    from mauvealigner_tpu_torch.parallel import multihost

    n_dev = mesh.size
    P = len(drafts)
    if P == 0:
        return []
    if device is None:
        device = mesh.devices[mesh.local_shards()[0]]
    ref_sml = build_mer_list_device(ref, seed, device)
    cols = [
        matchops._concat_device_smls([ref_sml, build_mer_list_device(d, seed, device)])
        for d in drafts
    ]
    N = max(int(k.shape[0]) for k, _, _ in cols)
    Pp = -(-P // n_dev) * n_dev
    K = torch.full((Pp, N), INVALID_KEY, dtype=torch.int64, device=device)
    S = torch.zeros((Pp, N), dtype=torch.int32, device=device)
    Ppos = torch.zeros((Pp, N), dtype=torch.int32, device=device)
    for i, (k, s, p) in enumerate(cols):
        n = int(k.shape[0])
        K[i, :n], S[i, :n], Ppos[i, :n] = k, s, p
    del cols
    K, S, Ppos = (multihost.scatter_global(x, mesh) for x in (K, S, Ppos))
    cap = max(1 << 14, N >> 3)
    while True:
        tabs = sharded_pair_mum_tables(K, S, Ppos, 2, cap, mesh)
        head = _head_rows(mesh, tabs, cap).reshape(Pp, -1, 4)
        n_runs = head[:, 0, 0]
        if (n_runs > cap).any():
            # capacity overflow (repeat-dense draft): retry with the covering
            # power of two; truncating would silently drop anchors
            cap = 1 << int(int(n_runs.max()) - 1).bit_length()
            continue
        break
    out = []
    for i in range(P):
        ml = matchops.decode_mum_table(head[i], 2, cap, seed.length)
        if extend and len(ml):
            ml = matchops.extend_matches_maximal(ml, [ref.codes, drafts[i].codes])
        out.append(ml)
    return out


def sort_contigs_sharded(
    ref,
    drafts,
    mesh: Mesh,
    seed_weight: Optional[int] = None,
    device=None,
):
    """The draft workflow's front half (BASELINE config 5) over the mesh:
    the per-draft reference-vs-draft MUM searches are split over the shards;
    LCB determination, the placement walk and contig reordering stay on the
    host per draft.

    Returns [(reordered genome, placement log)] per draft: exactly what the
    sequential flow gives (utils/digest.sort_drafts: MauveAligner.find_mums
    and determine_lcbs with default options, then
    tools.manipulate.sort_contigs)."""
    from mauvealigner_tpu_torch.models.lcb import greedy_breakpoint_elimination
    from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
    from mauvealigner_tpu_torch.tools.manipulate import (
        contig_placements_from_lcbs,
        sort_contigs,
    )

    if not drafts:
        return []
    # the sequential flow picks the default seed per (ref, draft) pair
    # (MauveAligner.find_mums averages the pair's lengths); group drafts by
    # that weight so every pair searches with the seed it would get
    by_weight: Dict[int, List[int]] = {}
    for i, d in enumerate(drafts):
        w = seed_weight or default_mer_size(int(np.mean([len(ref), len(d)])))
        by_weight.setdefault(w, []).append(i)
    out: list = [None] * len(drafts)
    for weight, idxs in by_weight.items():
        seed = get_seed(weight, 0)
        mls = find_pair_mums_sharded(ref, [drafts[i] for i in idxs], seed, mesh, device=device)
        for i, ml in zip(idxs, mls):
            d = drafts[i]
            # MauveAligner.determine_lcbs with default options: n-way
            # filter, overlap elimination, re-filter, then greedy breakpoint
            # elimination at seed_weight*3*n_seqs
            ml = ml.multiplicity_filter(2)
            ml = ml.eliminate_overlaps().multiplicity_filter(2)
            _, lcbs = greedy_breakpoint_elimination(ml, float(weight * 3 * 2))
            placements = contig_placements_from_lcbs(d, lcbs, draft_seq_index=1)
            out[i] = sort_contigs(d, placements)
    return out
