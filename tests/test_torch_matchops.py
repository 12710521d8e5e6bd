"""K2 parity: the port's multi-MUM search equals the JAX package's device
search on the same inputs, row for row and in the same order (exact:
MatchList rows are integers), and the group signatures are bit-equal."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.core.sml import build_mer_list_device as jax_mer_list
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu.models.aligner import AlignerOptions as JaxOptions
from mauvealigner_tpu.models.aligner import MauveAligner as JaxAligner
from mauvealigner_tpu.ops import matchops as jax_matchops
from mauvealigner_tpu.seeds import default_mer_size
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.core.sml import build_mer_list_device
from mauvealigner_tpu_torch.ops import matchops
from mauvealigner_tpu_torch.seeds import SOLID_SEED, get_seed

torch.set_num_threads(1)


def _both(jax_genomes, seed, **kw):
    ref = jax_matchops.find_multi_mums_device(
        jax_genomes, [jax_mer_list(g, seed) for g in jax_genomes],
        seed_length=seed.length, **kw,
    )
    gs = interop.genomes(jax_genomes)
    got = matchops.find_multi_mums_device(
        gs, [build_mer_list_device(g, seed, "cpu") for g in gs],
        seed_length=seed.length, **kw,
    )
    return ref, got


def _assert_same(ref, got):
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)


@pytest.mark.parametrize("divergence", [0.0, 0.01, 0.05])
def test_pairwise_matches_jax(rng, divergence):
    anc = simulate.random_genome(rng, 3000)
    der, _ = simulate.evolve(anc, rng, sub_rate=divergence, ins_rate=divergence / 5,
                             del_rate=divergence / 5)
    ref, got = _both([anc, der], get_seed(9, 0))
    assert len(ref) > 0
    _assert_same(ref, got)


def test_inversion_matches_jax(rng):
    anc = simulate.random_genome(rng, 4000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    der = simulate.apply_inversion(der, 1500, 2500)
    ref, got = _both([anc, der], get_seed(9, 0))
    assert (got.starts[:, 1] < 0).any()
    _assert_same(ref, got)


def test_three_way_matches_jax(rng):
    anc = simulate.random_genome(rng, 2000)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    ref, got = _both([anc, d1, d2], get_seed(9, SOLID_SEED))
    _assert_same(ref, got)


def test_seq_mask_matches_jax(rng):
    anc = simulate.random_genome(rng, 1500)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    mask = np.array([1, 1, 0], np.int32)
    ref, got = _both([anc, d1, d2], get_seed(9, 0), seq_mask=mask)
    assert (got.starts[:, 2] == 0).all()
    _assert_same(ref, got)


def test_tiny_cap_retry_matches_jax(rng):
    """A capacity-busting initial cap re-runs with a larger cap: same rows
    as the JAX search and as an ample-cap run, and no truncation warning."""
    anc = simulate.random_genome(rng, 6000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.05)
    seed = get_seed(9, 0)
    gs = interop.genomes([anc, der])
    smls = [build_mer_list_device(g, seed, "cpu") for g in gs]
    big = matchops.find_multi_mums_device(gs, smls, seed_length=seed.length)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        small = matchops.find_multi_mums_device(
            gs, smls, seed_length=seed.length, initial_cap=16
        )
    assert len(big) > 16
    _assert_same(big, small)
    ref, _ = _both([anc, der], seed, initial_cap=16)
    _assert_same(ref, small)


@pytest.mark.parametrize("pack_sort", [False, True])
def test_sig_phase_signatures_bit_equal(rng, pack_sort):
    anc = simulate.random_genome(rng, 3000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    der = simulate.apply_inversion(der, 800, 1600)
    seed = get_seed(9, 0)
    gs = interop.genomes([anc, der])
    keys, seq_ids, pos = matchops._concat_device_smls(
        [build_mer_list_device(g, seed, "cpu") for g in gs]
    )
    mask = np.ones(2, np.int32)
    ref = jax_matchops._sig_phase(
        jnp.asarray(keys.numpy()), jnp.asarray(seq_ids.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(mask), 2, 2, pack_sort,
    )
    got = matchops._sig_phase(keys, seq_ids, pos, torch.from_numpy(mask), 2, 2)
    names = ("seg_id", "kept", "is_rep", "rep_sig1", "seq", "pos", "signed_pos", "ref_pos")
    for name, r, g in zip(names, ref, got):
        assert np.array_equal(np.asarray(r), g.numpy()), name
    sig = got[3].numpy()
    assert sig.dtype == np.int64 and (sig[got[2].numpy()] < 0).any()  # wrapped


def _first_recursion_specs(jax_genomes):
    """The gap specs of the first recursion round of a real alignment, as
    MauveAligner.recursive_anchor groups them (by seed weight)."""
    al = JaxAligner(JaxOptions(seed_size=11, use_sml_cache=False))
    ml = al.find_mums(jax_genomes)
    ml, lcbs = al.determine_lcbs(jax_genomes, ml)
    ml, lcbs = al.extend_lcbs(jax_genomes, ml, lcbs)
    specs_by_w = {}
    for lcb in lcbs:
        sub = ml.select(lcb.match_indices)
        if len(sub) < 2:
            continue
        left, right, strand = al._gap_region_table(sub)
        lens = np.maximum(0, right - left + 1)
        qual = (lens.max(axis=1) >= 200) & (lens.min(axis=1) > 0)
        for a in np.nonzero(qual)[0]:
            w = max(5, min(default_mer_size(float(max(lens[a].mean(), 4.0))), al._seed_weight - 2))
            specs_by_w.setdefault(w, []).append(np.stack([left[a], right[a], strand[a]], axis=1))
    return {w: np.stack(v) for w, v in specs_by_w.items()}


def test_gap_mums_batched_matches_jax(rng):
    anc = simulate.random_genome(rng, 20000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    c = der.codes.copy()
    # highly diverged stretches leave anchor gaps for recursion, one of them
    # inside an inversion
    for a, b in ((2000, 2600), (5000, 5800), (9000, 9600), (12000, 12700), (15300, 16000)):
        hit = rng.random(b - a) < 0.45
        c[a:b][hit] = (c[a:b][hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    c[15000:17000] = (3 - c[15000:17000])[::-1]
    der = JaxGenome(np.frombuffer(b"ACGTN", np.uint8)[c], name="der")
    specs_by_w = _first_recursion_specs([anc, der])
    assert specs_by_w, "the input should leave gaps for recursion"
    gs = interop.genomes([anc, der])
    for w, specs in sorted(specs_by_w.items()):
        seed = get_seed(w, 0)
        lens = specs[:, :, 1] - specs[:, :, 0] + 1
        specs = specs[(lens >= seed.length).all(axis=1)]
        ref_ids, ref = jax_matchops.find_gap_mums_batched([anc, der], specs, seed)
        got_ids, got = matchops.find_gap_mums_batched(gs, specs, seed, "cpu")
        assert len(np.unique(got_ids)) > 1 and (got.starts < 0).any()
        assert np.array_equal(ref_ids, got_ids)
        _assert_same(ref, got)
