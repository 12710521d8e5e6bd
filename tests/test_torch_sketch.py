"""The candidate search behind progressiveMauve's default gate, in both
packages on the CPU.  Above 4,000,000 bases in all the gate decides on a
1/16 mer sketch (ProgressiveOptions.distance_sketch) and compares its n-way
coverage with tree_progressive_threshold; the extant branch then searches
again at full density.  On 9 genomes of config 3's recipe
(scripts/bench_configs.py config3: seed 37, sub 0.02, indel 0.001) at
60 kbp, the port's ProgressiveMauve.find_matches gives the JAX package's
match table with and without the sketch, and both read the same n-way
coverage from each."""

import numpy as np
import pytest
import torch

from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.models import progressive as port_progressive
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve as TorchProgressive
from mauvealigner_tpu_torch.utils import digest

torch.set_num_threads(1)

GENOME_LEN = 60_000


@pytest.fixture(scope="module")
def genomes():
    """(JAX-package genomes, the port's copies) of config 3's recipe at
    9 x 60 kbp."""
    g = digest.config3_genomes(simulate, GENOME_LEN)
    return g, interop.genomes(g)


@pytest.fixture(scope="module", params=[16, 1], ids=["sketch16", "full"])
def searches(request, genomes):
    """(sketch_mod, JAX match list, port match list) of one search."""
    jax_g, port_g = genomes
    o = ProgressiveOptions(use_sml_cache=False)
    ref = ProgressiveMauve(o).find_matches(jax_g, sketch_mod=request.param)
    got = TorchProgressive(interop.progressive_options(o, "cpu")).find_matches(
        port_g, sketch_mod=request.param)
    return request.param, ref, got


def test_find_matches_equal_jax(searches):
    """The same match table, row for row."""
    _, ref, got = searches
    assert len(got) > 0
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)


def test_nway_coverage_equal_jax(searches, genomes):
    """Both packages read the same n-way coverage; the sketch finds a
    sixteenth of the mers, so it reads far less than the full search."""
    sketch_mod, ref, got = searches
    jax_g, port_g = genomes
    cov = port_progressive.nway_coverage(got, port_g)
    assert cov == port_progressive.nway_coverage(ref, jax_g)
    if sketch_mod == 1:
        assert cov > 0.9
    else:
        assert 0 < cov < 0.5
