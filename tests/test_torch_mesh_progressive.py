"""Mesh parity of the port's aligners on the CPU: ProgressiveMauve (the
extant branch and the consensus ladder) and MauveAligner under
make_mesh(8, device="cpu") write XMFA byte-identical to the port's
single-device run and to the JAX package's run under its 8-virtual-device
mesh (tests/conftest.py), on the inputs of tests/test_mesh_progressive.py
and tests/test_parallel.py.  Under the mesh the N-way anchor search is the
two-phase all-to-all search, and every DP and HMM batch is split over the
shards."""

import io

import pytest
import torch

from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.parallel import make_mesh as jax_make_mesh
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.models.aligner import MauveAligner as TorchAligner
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve as TorchProgressive
from mauvealigner_tpu_torch.ops import gotoh_cuda
from mauvealigner_tpu_torch.parallel import make_mesh
from mauvealigner_tpu_torch.utils import timing

torch.set_num_threads(1)


def _xmfa(res) -> str:
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    return buf.getvalue()


def _family(rng, n, size, sub_rate):
    anc = simulate.random_genome(rng, size)
    genomes = []
    for i in range(n):
        g, _ = simulate.evolve(anc, rng, sub_rate=sub_rate, ins_rate=0.001, del_rate=0.001)
        if i % 2 == 1:
            a = size // 4
            g = simulate.apply_inversion(g, a, a + size // 5)
        g.name = f"g{i}"
        genomes.append(g)
    return genomes


def _progressive(genomes, tree_progressive):
    """(JAX mesh XMFA, port single-device XMFA, port mesh XMFA, the port
    mesh run's sharded-search counter and forward launch batches)."""
    o = ProgressiveOptions(mesh=jax_make_mesh(8), tree_progressive=tree_progressive)
    want = _xmfa(ProgressiveMauve(o).align(genomes))
    tg = interop.genomes(genomes)
    mesh_opts = interop.progressive_options(o, "cpu")
    assert mesh_opts.mesh.size == 8
    single_opts = interop.progressive_options(
        ProgressiveOptions(tree_progressive=tree_progressive), "cpu")
    single = _xmfa(TorchProgressive(single_opts).align(tg))
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    meshed = _xmfa(TorchProgressive(mesh_opts).align(tg))
    batches = [s["B"] for s in gotoh_cuda.LAUNCH_SHAPES]
    return want, single, meshed, timing.GLOBAL.counters.get("k2_sharded_entries_per_device", 0), batches


def test_mesh_progressive_extant_identical(rng):
    """Extant (full-multiplicity anchoring) path, 3-way with an inversion."""
    want, single, meshed, per_dev, batches = _progressive(_family(rng, 3, 30_000, 0.03), False)
    assert meshed == single == want
    assert want.count(">") >= 3
    assert per_dev > 0 and batches


def test_mesh_progressive_ladder_identical(rng):
    """Tree-progressive (consensus-ladder) path, 4-way with inversions:
    node-merge anchor searches, closure DP and the backbone decode all run
    on the mesh."""
    want, single, meshed, per_dev, batches = _progressive(_family(rng, 4, 25_000, 0.06), True)
    assert meshed == single == want
    assert per_dev > 0 and batches


def test_flagship_aligner_under_mesh_identical(rng):
    """MauveAligner with its anchor search over the mesh (and its closure DP
    split over it): the single-device XMFA and the JAX package's mesh XMFA."""
    anc = simulate.random_genome(rng, 6000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    genomes = [anc, simulate.apply_inversion(der, 2000, 3500)]
    o = AlignerOptions(seed_size=11, use_sml_cache=False, mesh=jax_make_mesh(8))
    want = _xmfa(MauveAligner(o).align(genomes))
    tg = interop.genomes(genomes)
    topts = interop.aligner_options(o, "cpu")
    meshed = _xmfa(TorchAligner(topts).align(tg))
    topts.mesh = None
    single = _xmfa(TorchAligner(topts).align(tg))
    assert meshed == single == want


@pytest.mark.parametrize("D", [2, 5])
def test_aligner_mesh_sizes_agree(rng, D):
    """Any mesh size gives the single-device XMFA (a non-power-of-two mesh
    pads the entry rows and splits DP batches unevenly)."""
    anc = simulate.random_genome(rng, 5000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    tg = interop.genomes([anc, der])
    o = interop.aligner_options(AlignerOptions(seed_size=11, use_sml_cache=False), "cpu")
    single = _xmfa(TorchAligner(o).align(tg))
    o.mesh = make_mesh(D, device="cpu")
    assert _xmfa(TorchAligner(o).align(tg)) == single
