"""K1 parity: the port's spaced-mer packing equals the JAX package's, key
for key (exact: keys are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.core.sml import build_mer_list_device as jax_build_mer_list_device
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu.ops import merops as jax_merops
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.core.sml import build_mer_list_device
from mauvealigner_tpu_torch.ops import merops
from mauvealigner_tpu_torch.seeds import SOLID_SEED, get_seed

torch.set_num_threads(1)


def _codes_with_n_runs(rng, n):
    codes = rng.integers(0, 4, size=n).astype(np.int32)
    codes[100:140] = 4  # an N run longer than any seed
    codes[rng.random(n) < 0.01] = 4  # scattered ambiguity codes
    return codes


@pytest.mark.parametrize("weight", [5, 11, 15, 19])
def test_pack_canonical_mers_matches_jax(weight):
    rng = np.random.default_rng(weight)
    codes = _codes_with_n_runs(rng, 3000)
    seed = get_seed(weight, 0)
    offs = tuple(int(o) for o in seed.offsets)
    ref = np.asarray(jax_merops.pack_canonical_mers(jnp.asarray(codes), offs, seed.length))
    got = merops.pack_canonical_mers(torch.from_numpy(codes), offs, seed.length).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(ref, got)
    if 2 * weight + 1 > 32:
        assert (got[got != merops.INVALID_KEY] >= 2**32).any()  # past 32-bit keys


@pytest.mark.parametrize("weight,rank", [(9, SOLID_SEED), (11, 1), (13, 2)])
def test_build_mer_list_device_matches_jax(weight, rank):
    rng = np.random.default_rng(weight)
    seq = np.frombuffer(b"ACGTN", np.uint8)[_codes_with_n_runs(rng, 2500)]
    g = JaxGenome(seq, name="g")
    seed = get_seed(weight, rank)
    ref_keys, ref_pos = (np.asarray(x) for x in jax_build_mer_list_device(g, seed))
    keys, pos = build_mer_list_device(interop.genome(g), seed, "cpu")
    n = keys.shape[0]
    assert n == len(g) + 1
    # the JAX list pads to a bucketed length; the padding is all INVALID
    assert np.array_equal(ref_keys[:n], keys.numpy())
    assert np.array_equal(ref_pos[:n], pos.numpy())
    assert (ref_keys[n:] == jax_merops.INVALID_KEY).all()
