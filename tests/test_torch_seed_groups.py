"""Slice-5 parity of the sorted mer list and the host seed-group path: the
port's sorted K1 (ops/merops.build_sorted_mer_list, core/sml.build_sml), its
disk cache (core/sml.load_sml), its seed groups and what reads them
(ops/matchops: build_seed_groups, repeat_matches_from_groups,
merge_collinear_runs, find_multi_mums) against the JAX package on the CPU.
Every comparison is exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.core import sml as jax_sml
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu.genome.sequence import revcomp_ascii
from mauvealigner_tpu.ops import matchops as jax_matchops
from mauvealigner_tpu.ops import merops as jax_merops
from mauvealigner_tpu.seeds import get_seed as jax_get_seed
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.core import sml
from mauvealigner_tpu_torch.ops import matchops, merops
from mauvealigner_tpu_torch.seeds import get_seed

torch.set_num_threads(1)


def _genome(rng, n=3000, with_n=False, name="g"):
    seq = simulate.random_genome(rng, n).seq.copy()
    if with_n:
        seq[n // 3 : n // 3 + 7] = ord("N")
        seq[n - 5] = ord("N")
    return JaxGenome(seq, name=name)


def _strand_mixed_genome(rng):
    """One genome holding a unit forward and reverse-complemented, the
    reverse copy first: within each shared mer its strand-1 entry (lower
    position) sorts after its strand-0 entry in a key-sorted SML."""
    unit = simulate.random_genome(rng, 120).seq
    sp = lambda n: simulate.random_genome(rng, n).seq  # noqa: E731
    return JaxGenome(
        np.concatenate([sp(200), revcomp_ascii(unit), sp(300), unit, sp(150), unit, sp(100)]),
        name="mixed",
    )


def _smls_both(genomes, weight):
    """(JAX SMLs, port SMLs) of the same genomes."""
    jseed, tseed = jax_get_seed(weight), get_seed(weight)
    ref = [jax_sml.build_sml(g, jseed) for g in genomes]
    got = [sml.build_sml(interop.genome(g), tseed, "cpu") for g in genomes]
    return ref, got


@pytest.mark.parametrize("weight", [5, 9, 15])
def test_sorted_mer_list_matches_jax(rng, weight):
    g = _genome(rng, 2000, with_n=True)
    seed_j, seed_t = jax_get_seed(weight), get_seed(weight)
    offs = tuple(int(o) for o in seed_j.offsets)
    codes = jax_merops.pad_codes(g.codes.astype(np.int32), seed_j.length)
    kj, pj, nj = jax_merops.build_sorted_mer_list(jnp.asarray(codes), offs, seed_j.length)
    dev = sml.upload_codes(interop.genome(g), seed_t.length, "cpu")
    kt, pt, nt = merops.build_sorted_mer_list(dev, offs, seed_t.length)
    assert int(nj) == nt
    assert np.array_equal(np.asarray(kj)[:nt], kt[:nt].numpy())
    assert np.array_equal(np.asarray(pj)[:nt], pt[:nt].numpy())
    # the tail holds exactly the invalid windows
    assert (kt[nt:] == merops.INVALID_KEY).all()


def test_sort_key_pos_matches_jax(rng):
    keys = rng.integers(0, 50, size=500).astype(np.int64)
    keys[::7] = np.int64(merops.INVALID_KEY)
    pos = np.arange(500, dtype=np.int32)
    kj, pj = jax_merops.sort_key_pos(jnp.asarray(keys), jnp.asarray(pos))
    kt, pt = merops.sort_key_pos(torch.from_numpy(keys), torch.from_numpy(pos))
    assert np.array_equal(np.asarray(kj), kt.numpy())
    assert np.array_equal(np.asarray(pj), pt.numpy())


@pytest.mark.parametrize("n", [3, 9, 4000])
def test_build_sml_matches_jax(rng, n):
    """Genomes shorter than, near and far above the seed length."""
    g = _genome(rng, n, with_n=n > 100)
    (ref,), (got,) = _smls_both([g], 9)
    assert got.keys.dtype == np.int64 and got.positions.dtype == np.int32
    assert np.array_equal(ref.keys, got.keys)
    assert np.array_equal(ref.positions, got.positions)
    assert got.seq_length == n


@pytest.mark.parametrize("weight", [9, 15])
def test_sml_accessors_match_jax(rng, weight):
    """seed_weight, seed_length, unique_mer_count and the mer at every
    sorted index equal the JAX SortedMerList's."""
    (ref,), (got,) = _smls_both([_genome(rng, 2500, with_n=True)], weight)
    assert got.seed_weight == ref.seed_weight == weight
    assert got.seed_length == ref.seed_length
    assert got.unique_mer_count() == ref.unique_mer_count()
    mers = [got.get_mer_at_sorted_index(i) for i in range(len(got.keys))]
    assert mers == [ref.get_mer_at_sorted_index(i) for i in range(len(ref.keys))]
    assert all(type(m) is int for m in mers) and mers == sorted(mers)


def _groups_equal(ref, got):
    for f in ("mer", "seq", "pos", "strand", "seg_id", "occ_unique"):
        a, b = getattr(ref, f), getattr(got, f)
        assert np.array_equal(a, b), f
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
    assert ref.n_segs == got.n_segs


@pytest.mark.parametrize("n_genomes", [1, 3])
def test_seed_groups_match_jax(rng, n_genomes):
    """Both strands of one mer in one genome, one and several genomes."""
    genomes = [_strand_mixed_genome(rng) for _ in range(n_genomes)]
    ref_s, got_s = _smls_both(genomes, 9)
    _groups_equal(jax_matchops.build_seed_groups(ref_s),
                  matchops.build_seed_groups(got_s, "cpu"))


def test_seed_group_order_is_full_sort(rng):
    """The port's groups equal the JAX package's (mer, genome, position)
    order on an input where a stable sort by mer alone of the concatenated
    key-sorted SMLs gives another order (which would move each group's
    reference component, its strand, and every repeat family)."""
    genomes = [_strand_mixed_genome(rng), _genome(rng, 800)]
    ref_s, got_s = _smls_both(genomes, 9)
    ref = jax_matchops.build_seed_groups(ref_s)
    # the order a stable mer-only sort would give
    keys = np.concatenate([s.keys for s in got_s])
    pos = np.concatenate([s.positions for s in got_s])
    mer_only = np.argsort(keys >> 1, kind="stable")
    assert not np.array_equal(pos[mer_only], ref.pos), "input does not tell the orders apart"
    got = matchops.build_seed_groups(got_s, "cpu")
    _groups_equal(ref, got)


@pytest.mark.parametrize("only_direct", [False, True])
def test_repeat_matches_match_jax(rng, only_direct):
    g = _strand_mixed_genome(rng)
    ref_s, got_s = _smls_both([g], 9)
    ref = jax_matchops.repeat_matches_from_groups(
        jax_matchops.build_seed_groups(ref_s), 9 + 2, min_multi=2, max_multi=500,
        only_direct=only_direct)
    got = matchops.repeat_matches_from_groups(
        matchops.build_seed_groups(got_s, "cpu"), 9 + 2, min_multi=2, max_multi=500,
        only_direct=only_direct)
    assert len(ref) > 0
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)
    assert bool((got.starts < 0).any()) != only_direct


def test_merge_collinear_runs_matches_jax(rng):
    g = _strand_mixed_genome(rng)
    seed = jax_get_seed(9)
    ref_s, got_s = _smls_both([g], 9)
    ml = matchops.repeat_matches_from_groups(
        matchops.build_seed_groups(got_s, "cpu"), seed.length)
    pos0 = np.where(ml.starts != 0, np.abs(ml.starts) - 1, -1)
    rel = np.where(ml.starts < 0, 1, 0).astype(np.int8)
    ref_seq = np.zeros(len(ml), np.int32)
    ref = jax_matchops.merge_collinear_runs(pos0, rel, ref_seq, seed.length)
    got = matchops.merge_collinear_runs(pos0, rel, ref_seq, seed.length)
    assert len(got) < len(ml)  # runs really merge
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)


@pytest.mark.parametrize("nway", [False, True])
def test_find_multi_mums_matches_jax(rng, nway):
    anc = simulate.random_genome(rng, 4000)
    genomes = [anc] + [simulate.evolve(anc, rng, sub_rate=0.03)[0] for _ in range(2)]
    ref_s, got_s = _smls_both(genomes, 9)
    ref = jax_matchops.find_multi_mums(genomes, ref_s, nway=nway)
    got = matchops.find_multi_mums(interop.genomes(genomes), got_s, nway=nway, device="cpu")
    assert len(ref) > 0
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sml_cache_read_across_packages(rng, tmp_path, writer):
    """A cache file written by either package is read, not rebuilt, by the
    other, and holds what a fresh build holds."""
    g = _genome(rng, 3000)
    g.filename = str(tmp_path / "g.fa")
    tg = interop.genome(g)
    jseed, tseed = jax_get_seed(9), get_seed(9)
    path = tmp_path / f"g.fa.{jseed.pattern}.sslist.npz"
    if writer == "jax":
        first = jax_sml.load_sml(g, jseed)
    else:
        first = sml.load_sml(tg, tseed, device="cpu")
    assert path.exists()
    stamp = os.stat(path).st_mtime_ns
    if writer == "jax":
        second = sml.load_sml(tg, tseed, device="cpu")
    else:
        second = jax_sml.load_sml(g, jseed)
    assert os.stat(path).st_mtime_ns == stamp
    fresh = sml.build_sml(tg, tseed, "cpu")
    for s in (first, second):
        assert np.array_equal(s.keys, fresh.keys)
        assert np.array_equal(s.positions, fresh.positions)


def test_sml_cache_falls_back_to_registered_temp_path(rng, tmp_path):
    """When the cache cannot be written beside the sequence, it goes to a
    registered scratch path, where the next load finds it."""
    tg = interop.genome(_genome(rng, 2000))
    tg.filename = str(tmp_path / "missing_dir" / "g.fa")
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    seed = get_seed(9)
    sml.register_temp_path(str(scratch))
    try:
        first = sml.load_sml(tg, seed, device="cpu")
        cached = scratch / f"g.fa.{seed.pattern}.sslist.npz"
        assert cached.exists()
        stamp = os.stat(cached).st_mtime_ns
        second = sml.load_sml(tg, seed, device="cpu")
        assert os.stat(cached).st_mtime_ns == stamp
        assert np.array_equal(first.keys, second.keys)
    finally:
        sml._temp_paths.remove(str(scratch))


def test_sml_cache_rebuilds_stale_file(rng, tmp_path):
    """A cache file for another sequence length is rebuilt and rewritten."""
    g = _genome(rng, 2000)
    tg = interop.genome(g)
    tg.filename = str(tmp_path / "g.fa")
    seed = get_seed(9)
    path = sml._cache_path(tg.filename, seed)
    np.savez(path, version=1, pattern=seed.pattern, seq_length=5,
             keys=np.zeros(1, np.int64), positions=np.zeros(1, np.int32))
    got = sml.load_sml(tg, seed, device="cpu")
    assert np.array_equal(got.keys, sml.build_sml(tg, seed, "cpu").keys)
    with np.load(path) as z:
        assert int(z["seq_length"]) == len(tg)
