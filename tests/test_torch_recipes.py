"""BASELINE configs 1, 2 and 3 at E. coli length (utils/digest.BACTERIAL_RECIPES),
each at 1/50 of its length on the CPU: the genomes equal, by sha256, the
JAX package's simulate recipe as bench.py and scripts/bench_configs.py
write it out (config 2's inversion bounds scaled alike); the golden file
that scripts/make_port_golden.py writes for the run (the JAX package) and
the chip check's phase for it (chip_smoke.py, the port on the CPU, its
plain versions counted as launches) agree in every field the phase holds.
For config 2 those fields are the sha256 of every file the two packages'
mauveAligner command lines write, so the files are byte-identical."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch.ops import dp, gotoh_cuda
from mauvealigner_tpu_torch.utils import digest
from mauvealigner_tpu_torch.utils import simulate as port_simulate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SCALE = 50


def _jax_recipe(kind: str, n: int) -> list:
    """The recipe of bench.py config 1 / scripts/bench_configs.py config2
    and config3 at length n, with the JAX package's simulate module."""
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, n)
    if kind == "config1_bacterial":
        return [anc, simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)[0]]
    if kind == "config2_bacterial":
        d1, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
        d2, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        # 150,000-250,000 of 500,000 bases
        return [anc, d1, simulate.apply_inversion(d2, n * 150_000 // 500_000, n * 250_000 // 500_000)]
    return [anc] + [simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)[0]
                    for _ in range(8)]


def _counting(name, fn):
    def call(*args, **kwargs):
        gotoh_cuda.count_launch(name)
        return fn(*args, **kwargs)
    return call


@pytest.mark.parametrize("kind", list(digest.BACTERIAL_RECIPES))
def test_bacterial_recipe_golden_and_phase(kind, tmp_path):
    import chip_smoke
    import make_port_golden

    recipe, n = digest.BACTERIAL_RECIPES[kind]
    genomes = recipe(port_simulate, n // SCALE)
    jax_genomes = _jax_recipe(kind, n // SCALE)
    assert [len(g) for g in genomes] == [len(g) for g in jax_genomes]
    assert digest.genome_sha256(genomes) == digest.genome_sha256(jax_genomes)

    # the golden script's subcommand and the chip check's phase for a run
    # are both named after it
    with mock.patch.dict(digest.BACTERIAL_RECIPES, {kind: (recipe, n // SCALE)}), \
            mock.patch.object(make_port_golden, "DATA", str(tmp_path)):
        getattr(make_port_golden, kind)()
    golden = json.loads((tmp_path / f"{kind}_golden.json").read_text())
    for key in ("jax_cpu_seconds", "genome_build_seconds", "peak_rss_gib"):
        assert golden[key] > 0
    assert golden["genome_sha256"] == digest.genome_sha256(genomes)

    # on the CPU the wrappers run the plain versions, which count no launch:
    # count them here so that the phase's launch checks can pass
    with mock.patch.object(chip_smoke, "DATA", str(tmp_path)), \
            mock.patch.object(chip_smoke, "card_line", lambda: "cpu"), \
            mock.patch.multiple(torch.cuda, synchronize=lambda *a: None,
                                reset_peak_memory_stats=lambda *a: None,
                                max_memory_allocated=lambda *a: 0), \
            mock.patch.multiple(
                dp, gotoh_forward_codes_ref=_counting("gotoh_forward_codes",
                                                      dp.gotoh_forward_codes_ref),
                gotoh_forward_profiles_ref=_counting("gotoh_forward_profiles",
                                                     dp.gotoh_forward_profiles_ref),
                gotoh_traceback_ref=_counting("gotoh_traceback", dp.gotoh_traceback_ref)):
        r = getattr(chip_smoke, kind)(torch.device("cpu"), genomes)
    assert r["launches"]["gotoh_forward_codes"] > 0 and r["launches"]["gotoh_traceback"] > 0
    assert sum(s["B"] for s in r["shapes"]) > 0
    if kind == "config2_bacterial":
        assert set(digest.CONFIG2_KEYS) <= set(golden)
    if kind == "config3_extant_bacterial":
        assert golden["branch"] == "extant"
        assert golden["gate"]["sketch_mod"] == 16 and golden["gate"]["threshold"] == 0.15
        assert golden["nway_coverage"] > golden["gate"]["sketched_nway_coverage"]
