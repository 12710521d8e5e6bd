"""Mesh parity: the port's parallel/ (mesh, sharded programs, batch
splitting) and the S-state HMM against the JAX package's on the CPU, at the
sizes of tests/test_parallel.py.  The JAX side runs over the 8 virtual CPU
devices of tests/conftest.py; the port over make_mesh(D, device="cpu"),
D logical shards of the CPU.

- _dispatch, sharded_pack_sort and sharded_mum_candidate_tables: the same
  buffers, sorted lists and packed tables as the JAX functions on the same
  inputs (bit-identical);
- find_multi_mums_sharded (D = 8 and 6), find_pair_mums_sharded and
  sort_contigs_sharded: the same match lists and placements as the JAX
  package's and as the port's single-device flow;
- shard_batched_call: bit-identical to the direct call when B does not
  divide by D;
- forward_backward / sharded_hmm_posteriors at S = 3: within 1e-6 absolute
  of the JAX package's (the S-state combine is a matrix product whose sum
  order may differ from XLA's einsum by an ulp), thresholded bits equal;
- the launch guard: a launch makes its inputs' CUDA device current.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.core.sml import build_mer_list_device as jax_mer_list
from mauvealigner_tpu.genome.sequence import Contig as JaxContig
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu.genome.sequence import revcomp_ascii
from mauvealigner_tpu.ops import hmm as jax_hmm
from mauvealigner_tpu.ops import matchops as jax_matchops
from mauvealigner_tpu.ops import merops as jax_merops
from mauvealigner_tpu.parallel import make_mesh as jax_make_mesh
from mauvealigner_tpu.parallel import sharded as jax_sharded
from mauvealigner_tpu.seeds import get_seed as jax_get_seed
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.core.sml import build_mer_list_device
from mauvealigner_tpu_torch.ops import dp, gotoh_cuda, hmm, matchops
from mauvealigner_tpu_torch.parallel import (
    Mesh,
    context,
    find_multi_mums_sharded,
    find_pair_mums_sharded,
    make_mesh,
    multihost,
    sharded,
    sharded_mum_candidate_tables,
    sharded_pack_sort,
    sort_contigs_sharded,
)
from mauvealigner_tpu_torch.seeds import get_seed

torch.set_num_threads(1)

HMM_TOL = 1e-6


def _rows(ml):
    return np.concatenate([ml.starts, ml.lengths[:, None]], axis=1)


def _family(rng, n_genomes, size):
    anc = simulate.random_genome(rng, size)
    genomes = [anc]
    for _ in range(n_genomes - 1):
        d, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        genomes.append(d)
    genomes[-1] = simulate.apply_inversion(genomes[-1], size // 3, 2 * size // 3)
    return genomes


def test_make_mesh_sizes():
    assert make_mesh(8, device="cpu").size == 8
    assert make_mesh(device="cpu").local_shards() == [0]
    with pytest.raises(ValueError):
        make_mesh(max(2, torch.cuda.device_count() + 1), device="cuda")


@pytest.mark.parametrize("C", [3, 40])
def test_dispatch_matches_jax(rng, C):
    """Order-stable slot assignment, fill values and the dropped count; at
    C = 3 most destinations overflow."""
    D, n = 5, 97
    part = rng.integers(0, D + 1, n).astype(np.int32)  # D drops the entry
    a = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    b = rng.integers(0, 1000, n).astype(np.int32)
    (ja, jb), jdrop = jax_sharded._dispatch(
        jnp.asarray(part), D, C, [(jnp.asarray(a), np.int64(-7)), (jnp.asarray(b), np.int32(3))]
    )
    (ta, tb), tdrop = sharded._dispatch(
        torch.from_numpy(part), D, C, [(torch.from_numpy(a), -7), (torch.from_numpy(b), 3)]
    )
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert int(jdrop) == int(tdrop)
    assert (int(tdrop) > 0) == (C == 3)


def test_canonical_splitters_match_jax():
    for w, D in ((9, 8), (15, 6), (21, 4)):
        assert np.array_equal(sharded._canonical_splitters(w, D), jax_sharded._canonical_splitters(w, D))


def test_sharded_pack_sort_matches_jax_and_single_device(make_dna):
    """The distributed SML build at D = 8: keys, positions and dropped equal
    to the JAX package's, and the concatenation less its INVALID entries
    equal to the port's single-device sorted list."""
    seed = jax_get_seed(9, 0)
    g = JaxGenome.from_string(make_dna(3000))
    codes = jax_merops.pad_codes(g.codes.astype(np.int32), seed.length, pad_to_multiple=1024)
    offsets = tuple(int(o) for o in seed.offsets)
    jk, jp, jdrop = jax_sharded.sharded_pack_sort(jnp.asarray(codes), offsets, seed.length,
                                                  jax_make_mesh(8))
    tk, tp, tdrop = sharded_pack_sort(codes, offsets, seed.length, make_mesh(8, device="cpu"))
    keys = torch.cat([tk[d] for d in range(8)]).numpy()
    pos = torch.cat([tp[d] for d in range(8)]).numpy()
    assert int(jdrop) == tdrop == 0
    assert np.array_equal(np.asarray(jk), keys)
    assert np.array_equal(np.asarray(jp), pos)
    ref_k, ref_p, n_valid = matchops.merops.build_sorted_mer_list(
        torch.from_numpy(codes), offsets, seed.length
    )
    valid = keys != matchops.INVALID_KEY
    assert int(valid.sum()) == n_valid
    assert np.array_equal(keys[valid], ref_k[:n_valid].numpy())
    assert np.array_equal(pos[valid], ref_p[:n_valid].numpy())


def test_sharded_mum_candidate_tables_match_jax(rng):
    """The two-phase all-to-all candidate search on the same entries and
    capacities: every shard's packed table and dropped count equal."""
    genomes = _family(rng, 3, 2500)
    seed = jax_get_seed(9, 0)
    keys, seq_ids, pos = jax_matchops._concat_device_smls(
        [jax_mer_list(g, seed) for g in genomes]
    )
    N, D = int(keys.shape[0]), 8
    C1 = (-(-2 * N // (D * D)) + 7) & ~7
    C2 = (2 * C1 + 7) & ~7
    cap = 1 << 10
    jt, jd = jax_sharded.sharded_mum_candidate_tables(
        keys, seq_ids, pos, 3, cap, C1, C2, jax_make_mesh(D)
    )
    mesh = make_mesh(D, device="cpu")
    sc = [multihost.scatter_global(np.asarray(x), mesh) for x in (keys, seq_ids, pos)]
    tt, td = sharded_mum_candidate_tables(*sc, 3, cap, C1, C2, mesh)
    assert np.array_equal(np.asarray(jt), torch.stack([tt[d] for d in range(D)]).numpy())
    assert np.array_equal(np.asarray(jd), torch.stack([td[d] for d in range(D)]).numpy())
    assert int(np.asarray(jt)[:, 0, 0].sum()) > 0


@pytest.fixture(scope="module")
def jax_multi_mums():
    """The JAX package's sharded search over its 8-device mesh, once per
    input (its output is canonical, the same at every mesh size)."""
    cache = {}

    def get(n_genomes, size):
        if (n_genomes, size) not in cache:
            genomes = _family(np.random.default_rng(37), n_genomes, size)
            seed = jax_get_seed(9, 0)
            cache[n_genomes, size] = genomes, jax_sharded.find_multi_mums_sharded(
                genomes, [jax_mer_list(g, seed) for g in genomes], jax_make_mesh(8),
                seed_length=seed.length,
            )
        return cache[n_genomes, size]

    return get


@pytest.mark.parametrize("n_genomes,size", [(2, 4000), (4, 3000)])
@pytest.mark.parametrize("D", [8, 6])
def test_find_multi_mums_sharded_matches_jax_and_single_device(jax_multi_mums, n_genomes, size, D):
    genomes, want = jax_multi_mums(n_genomes, size)
    tg = interop.genomes(genomes)
    tseed = get_seed(9, 0)
    smls = [build_mer_list_device(g, tseed, "cpu") for g in tg]
    got = find_multi_mums_sharded(tg, smls, make_mesh(D, device="cpu"), seed_length=tseed.length)
    single = matchops.find_multi_mums_device(tg, smls, seed_length=tseed.length)
    assert np.array_equal(_rows(want), _rows(got))
    assert set(map(tuple, _rows(single).tolist())) == set(map(tuple, _rows(got).tolist()))
    assert len(got) > 0


def test_find_multi_mums_sharded_capacity_retries(rng, monkeypatch):
    """Tiny slot capacities force the dropped-entry retry, and a tiny run
    capacity the head-slice retry: the result does not change."""
    genomes = interop.genomes(_family(rng, 2, 3000))
    seed = get_seed(9, 0)
    smls = [build_mer_list_device(g, seed, "cpu") for g in genomes]
    mesh = make_mesh(4, device="cpu")
    want = find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
    calls = []
    real = sharded.sharded_mum_candidate_tables

    def squeezed(k, s, p, n_seqs, cap_local, C1, C2, m, min_multi=2):
        # first call: capacities far too small; later calls as asked
        first = not calls
        calls.append((cap_local, C1, C2))
        if first:
            return real(k, s, p, n_seqs, cap_local, 8, 8, m, min_multi)
        return real(k, s, p, n_seqs, cap_local, C1, C2, m, min_multi)

    monkeypatch.setattr(sharded, "sharded_mum_candidate_tables", squeezed)
    got = find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
    assert len(calls) >= 2 and calls[1][1] > calls[0][1]
    assert np.array_equal(_rows(want), _rows(got))


def _drafts(rng, ref, n=3, sub=0.03):
    drafts = []
    for i in range(n):
        der, _ = simulate.evolve(ref, rng, sub_rate=sub, ins_rate=0.001, del_rate=0.001)
        cuts = np.sort(rng.choice(np.arange(500, len(der) - 500), size=3, replace=False))
        edges = np.concatenate([[0], cuts, [len(der)]])
        pieces = []
        for ci, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            chunk = der.seq[a:b]
            if rng.random() < 0.5:
                chunk = revcomp_ascii(chunk)
            pieces.append((f"d{i}_c{ci}", chunk))
        contigs, parts, off = [], [], 0
        for idx in rng.permutation(len(pieces)):
            cname, chunk = pieces[idx]
            contigs.append(JaxContig(cname, len(chunk), off))
            parts.append(chunk)
            off += len(chunk)
        drafts.append(JaxGenome(np.concatenate(parts), contigs=contigs, name=f"d{i}"))
    return drafts


def test_find_pair_mums_sharded_matches_jax_and_single_device(rng):
    """Pairs of two lengths (padded to one entry count), five pairs over
    eight shards (three all-INVALID pad rows): each pair's matches equal the
    JAX package's and the single-device search's, row for row."""
    seed = jax_get_seed(9, 0)
    anc = simulate.random_genome(rng, 3000, name="ref")
    drafts = []
    for i in range(5):
        der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        seq = der.seq
        if i >= 3:
            seq = np.concatenate([seq, simulate.random_genome(rng, 9000).seq])
        drafts.append(JaxGenome(seq, name=f"d{i}"))
    want = jax_sharded.find_pair_mums_sharded(anc, drafts, seed, jax_make_mesh(8))
    tref, tdrafts = interop.genome(anc), interop.genomes(drafts)
    tseed = get_seed(9, 0)
    got = find_pair_mums_sharded(tref, tdrafts, tseed, make_mesh(8, device="cpu"))
    assert len(got) == len(drafts)
    for d, w, g in zip(tdrafts, want, got):
        single = matchops.find_multi_mums_device(
            [tref, d], [build_mer_list_device(x, tseed, "cpu") for x in (tref, d)],
            seed_length=tseed.length,
        )
        assert np.array_equal(_rows(w), _rows(g))
        assert np.array_equal(_rows(single), _rows(g))
        assert len(g) > 0


def test_sort_contigs_sharded_matches_jax_and_sequential(rng):
    """The sharded draft front half gives the JAX package's placements and
    reordered drafts, and those of the port's sequential flow."""
    from mauvealigner_tpu_torch.models import aligner as aligner_mod
    from mauvealigner_tpu_torch.tools import manipulate
    from mauvealigner_tpu_torch.utils import digest

    ref = simulate.random_genome(rng, 6000, name="ref")
    drafts = _drafts(rng, ref)
    tref, tdrafts = interop.genome(ref), interop.genomes(drafts)
    want_seq, want_logs = digest.sort_drafts(tref, tdrafts, aligner_mod, manipulate, device="cpu")
    for weight in (9, None):
        jgot = jax_sharded.sort_contigs_sharded(ref, drafts, jax_make_mesh(8), seed_weight=weight)
        got = sort_contigs_sharded(tref, tdrafts, make_mesh(8, device="cpu"), seed_weight=weight)
        assert len(got) == 3
        for (jfixed, jlog), (fixed, log) in zip(jgot, got):
            assert [(n, int(s)) for n, s in log] == [(n, int(s)) for n, s in jlog]
            assert np.array_equal(fixed.seq, jfixed.seq)
        if weight is None:
            assert [log for _, log in got] == want_logs
            assert all(np.array_equal(f.seq, w.seq) for (f, _), w in zip(got, want_seq))
            assert sum(1 for _, log in got for _, s in log if s != 0) > 0


@pytest.mark.parametrize("B", [1, 5, 11])
def test_shard_batched_call_bit_identical(rng, B):
    """B not a multiple of D: split rows, concatenated in shard order, equal
    to the direct call; shards left empty launch nothing."""
    x = torch.from_numpy(rng.random((B, 7)))
    w = torch.from_numpy(rng.random((7, 3)))
    seen = []

    def kernel(a, m, device):
        seen.append(a.shape[0])
        return (a @ m, a.sum(dim=1))

    direct = context.shard_batched_call(kernel, [x], (w,), device="cpu")
    seen.clear()
    split = context.shard_batched_call(kernel, [x], (w,), mesh=make_mesh(4, device="cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(direct, split))
    assert sum(seen) == B and 0 not in seen and len(seen) == min(B, 4)
    with context.use_mesh(make_mesh(3, device="cpu")):
        ambient = context.shard_batched_call(kernel, [x], (w,), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(direct, ambient))


def test_dp_batches_split_under_mesh(rng):
    """Both DP launch sites under an ambient mesh: per-shard launches, the
    same op strings and scores as without."""
    B, side = 7, 32
    ca = np.full((B, side), 255, np.uint8)
    cb = np.full((B, side), 255, np.uint8)
    la = rng.integers(4, side + 1, B).astype(np.int32)
    lb = rng.integers(4, side + 1, B).astype(np.int32)
    for b in range(B):
        ca[b, : la[b]] = rng.integers(0, 4, la[b])
        cb[b, : lb[b]] = rng.integers(0, 4, lb[b])
    pa = np.stack([dp.one_hot_profile(np.minimum(ca[b, : la[b]], 4), side) for b in range(B)])
    pb = np.stack([dp.one_hot_profile(np.minimum(cb[b, : lb[b]], 4), side) for b in range(B)])
    want_c = dp.align_code_pairs_batch(ca, cb, la, lb, device="cpu")
    want_p = dp.align_profiles_batch(pa, pb, la, lb, device="cpu")
    gotoh_cuda.reset_launches()
    with context.use_mesh(make_mesh(3, device="cpu")):
        got_c = dp.align_code_pairs_batch(ca, cb, la, lb, device="cpu")
        got_p = dp.align_profiles_batch(pa, pb, la, lb, device="cpu")
    assert [s["B"] for s in gotoh_cuda.LAUNCH_SHAPES] == [3, 2, 2, 3, 2, 2]
    for want, got in ((want_c, got_c), (want_p, got_p)):
        assert np.array_equal(want[1], got[1])
        assert all(np.array_equal(a, b) for a, b in zip(want[0], got[0]))


def _hmm3(rng, B=6, T=48):
    le = np.log(rng.dirichlet(np.ones(3), size=(B, T))).astype(np.float32)
    trans = np.array([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]])
    lens = rng.integers(1, T + 1, B).astype(np.int64)
    lens[0] = T
    return le, np.log(trans), np.log(np.array([0.5, 0.3, 0.2])), lens


def test_forward_backward_three_states_matches_jax(rng):
    le, lt, li, lens = _hmm3(rng)
    want = np.asarray(jax_hmm.forward_backward(
        jnp.asarray(le), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lens)))
    got = hmm.forward_backward(torch.from_numpy(le), torch.from_numpy(lt),
                               torch.from_numpy(li), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == le.shape and got.dtype == np.float64
    assert np.abs(want - got).max() <= HMM_TOL
    assert np.array_equal(want > 0.5, got > 0.5)
    mesh_got = sharded.sharded_hmm_posteriors(le, lt, li, lens, make_mesh(4, device="cpu"))
    want_mesh = np.asarray(jax_sharded.sharded_hmm_posteriors(
        jnp.asarray(np.concatenate([le, le[:2]])), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(np.concatenate([lens, lens[:2]])), jax_make_mesh(8)))[: len(le)]
    assert np.array_equal(mesh_got, got)
    assert np.abs(want_mesh - mesh_got).max() <= HMM_TOL


def test_forward_backward_two_states_keeps_the_lanes(rng):
    """S = 2 routes to the four-lane chain (the same bits as
    emit_posterior0 on the exponentiated tables), both states within the
    bound of the JAX package's."""
    le = np.log(rng.dirichlet(np.ones(2), size=(5, 40))).astype(np.float32)
    lt = np.log(np.array([[0.95, 0.05], [0.1, 0.9]]))
    li = np.log(np.array([0.5, 0.5]))
    lens = np.array([40, 17, 1, 33, 40])
    t = torch.from_numpy
    got = hmm.forward_backward(t(le), t(lt), t(li), t(lens)).numpy()
    live = torch.arange(40)[None, :] < t(lens)[:, None]
    e = torch.exp(torch.where(live[:, :, None], t(le), 0.0))
    lanes = hmm.emit_posterior0(e[:, :, 0], e[:, :, 1], torch.exp(t(lt)), torch.exp(t(li)),
                                live).numpy()
    assert np.array_equal(got[:, :, 0], lanes)
    want = np.asarray(jax_hmm.forward_backward(*(jnp.asarray(x) for x in (le, lt, li, lens))))
    assert np.abs(want - got).max() <= HMM_TOL


@pytest.mark.parametrize("mode", ["posterior0", "threshold0", "prefix0"])
def test_bucketed_decode_three_states(rng, mode):
    """bucketed_decode at S = 3, symbol streams and emission rows, with and
    without a mesh: the JAX package's answers (posteriors within the
    bound)."""
    trans = np.log(np.array([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]]))
    init = np.log(np.array([0.6, 0.2, 0.2]))
    table = np.log(rng.dirichlet(np.ones(4), size=3))  # [S, n_symbols]
    streams = [rng.integers(0, 4, n).astype(np.uint8) for n in (5, 17, 40, 0, 33, 16)]
    rows = [table.T[s].astype(np.float32) for s in streams]
    for jobs, tab in ((streams, table), (rows, None)):
        want = jax_hmm.bucketed_decode(jobs, trans, init, mode, threshold=0.4, emit_table=tab)
        for mesh in (None, make_mesh(4, device="cpu")):
            with context.use_mesh(mesh):
                got = hmm.bucketed_decode(jobs, trans, init, mode, threshold=0.4,
                                          emit_table=tab, device="cpu")
            for w, g in zip(want, got):
                if mode == "posterior0":
                    assert np.abs(np.asarray(w, np.float64) - g).max(initial=0) <= HMM_TOL
                else:
                    assert np.array_equal(np.asarray(w), np.asarray(g))


def test_launch_guard_makes_the_device_current(monkeypatch):
    """A launch on a shard's card must run with that card current (the CUDA
    runtime launches on the current device): each wrapper's launch happens
    inside torch.cuda.device(the inputs' device).  Checked without a GPU by
    standing in for the device guard, the stream and the kernel library."""
    from mauvealigner_tpu_torch.ops import _build

    state = {"current": None, "entered": []}

    @contextlib.contextmanager
    def device(dev):
        prev, state["current"] = state["current"], dev
        state["entered"].append(dev)
        try:
            yield
        finally:
            state["current"] = prev

    class Stream:
        cuda_stream = 0

    class Lib:
        def gotoh_forward_scratch_bytes(self, *args):
            return 0

        def __getattr__(self, name):
            def launch(*args):
                assert state["current"] is not None, f"{name} launched outside the guard"
                launched.append((name, state["current"]))
                return 0
            return launch

    launched = []
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(_build, "library", lambda: Lib())
    dev = torch.device("cpu")
    B, M = 2, 8
    ca = torch.zeros((B, M), dtype=torch.uint8)
    lens = torch.full((B,), M, dtype=torch.int32)
    sub = torch.zeros((5, 5), dtype=torch.float32)
    prof = torch.zeros((B, M, 5), dtype=torch.float32)
    gotoh_cuda._forward_codes_launch(ca, ca, lens, lens, sub, -400.0, -30.0)
    gotoh_cuda._forward_profiles_launch(prof, prof, lens, lens, sub, -400.0, -30.0, False)
    dec = torch.zeros((B, 2 * M + 1, M + 1), dtype=torch.uint8)
    gotoh_cuda._traceback_launch(dec, lens, lens)
    assert [n for n, _ in launched] == [
        "gotoh_forward_codes_launch", "gotoh_forward_profiles_launch", "gotoh_traceback_launch"]
    assert all(d == dev for _, d in launched)
    assert state["entered"] == [dev, dev, dev] and state["current"] is None


def test_global_mesh_without_a_group():
    """No process group: a one-shard mesh on the device asked for, and
    init_multihost at one process is a no-op."""
    multihost.init_multihost("localhost:1", 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh("cpu")
    assert mesh == Mesh((torch.device("cpu"),)) and mesh.local_shards() == [0]
    x = np.arange(12).reshape(6, 2)
    blocks = multihost.scatter_global(x, make_mesh(3, device="cpu"))
    assert np.array_equal(multihost.fetch_replicated(blocks, make_mesh(3, device="cpu")).reshape(6, 2), x)
