"""Record reference outputs for the PyTorch port's chip check.

Runs the JAX package on the CPU and writes golden files under
mauvealigner_tpu_torch/data/, which chip_smoke.py holds the port to:

  1     config1_golden.json: config 1 (bench.py: two 1 Mbp genomes about
        1% apart, seed 37): the sha256 of both genomes' code arrays, the
        LCB / anchor / aligned-column counts and the sha256 of the XMFA
        text (seconds);
  3     config3_golden.json: BASELINE config 3 as
        scripts/bench_configs.py builds it (9 x 250 kbp, seed 37, sub 0.02,
        indel 0.001), default ProgressiveOptions: genome sha256, the gate
        branch, the guide tree, LCB and interval counts, the sha256 of the
        XMFA, .backbone and .bbcols texts (about half a minute);
  tree  tree_golden.json: the same fields for 9 x 1 Mbp enterobacteria-like
        genomes (utils/simulate.enterobacteria_like(1_000_000, 9, 0.08)),
        which take the tree-progressive branch, plus each (0, i) pair's
        sn / ppv against the simulation truths (a few minutes);
  4     config4_golden.json: BASELINE config 4, repeatoire on the 236 kbp
        planted-family genome of scripts/bench_configs.py config4
        (utils/simulate.planted_repeats()), default RepeatoireOptions, run
        as the CLI runs it with --seeds: the genome sha256, the family count
        and top multiplicity, the chained seed count and the sha256 of the
        XMFA, XML, procrast.highest, --score-out and --seeds texts (about
        40 s);
  4big  config4_big_golden.json: the same at bacterial scale, every spacer
        4x as long (planted_repeats(4), 926 kbp; about 80 s).

Usage:  JAX_PLATFORMS=cpu python scripts/make_port_golden.py [1] [3] [tree] [4] [4big]
        (no argument: all five)
"""

import argparse
import hashlib
import io
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from mauvealigner_tpu.core.mln import write_match_list  # noqa: E402
from mauvealigner_tpu.models import repeatoire  # noqa: E402
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner  # noqa: E402
from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions  # noqa: E402
from mauvealigner_tpu.utils import simulate, timing  # noqa: E402
from mauvealigner_tpu_torch import interop  # noqa: E402
from mauvealigner_tpu_torch.utils import digest  # noqa: E402
from mauvealigner_tpu_torch.utils import simulate as port_simulate  # noqa: E402

GENOME_SIZE = 1_000_000
SEED = 37
DATA = os.path.join(os.path.dirname(__file__), "..", "mauvealigner_tpu_torch", "data")


def _write(name: str, golden: dict) -> None:
    out = os.path.join(DATA, name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")
    print(json.dumps(golden))


def config3_genomes(simulate_mod, n=250_000, k=9):
    """scripts/bench_configs.py config3's genomes, from either package's
    simulate module."""
    rng = np.random.default_rng(SEED)
    anc = simulate_mod.random_genome(rng, n)
    genomes = [anc]
    for _ in range(k - 1):
        d, _ = simulate_mod.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        genomes.append(d)
    return genomes


def _progressive(genomes, label: str, bbcols_name: str) -> dict:
    timing.GLOBAL.reset()
    t0 = time.perf_counter()
    res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False)).align(genomes)
    seconds = time.perf_counter() - t0
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256(genomes),
        "genome_lengths": [len(g) for g in genomes],
        "bbcols_name": bbcols_name,
        **digest.progressive_digest(res, branch, bbcols_name),
    }
    print(f"{label}: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)
    return golden, res


def config3() -> None:
    golden, _ = _progressive(
        config3_genomes(simulate),
        "BASELINE config 3 (scripts/bench_configs.py config3): seed 37, "
        "random_genome(250_000) + 8 x evolve(sub_rate=0.02, ins_rate=0.001, "
        "del_rate=0.001), ProgressiveOptions(use_sml_cache=False)",
        "config3.xmfa.bbcols",
    )
    _write("config3_golden.json", golden)


def tree_branch() -> None:
    # the port's generator gives the same genomes as
    # scripts/bench_enterobacteria.build_genomes(1_000_000, 9, 0.08)
    t0 = time.perf_counter()
    pg, truths = port_simulate.enterobacteria_like(GENOME_SIZE, 9, 0.08)
    print(f"genomes built in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    genomes = [simulate.Genome(g.seq.copy(), name=g.name) for g in pg]
    golden, res = _progressive(
        genomes,
        "9 x 1 Mbp enterobacteria-like (utils/simulate.enterobacteria_like("
        "1_000_000, 9, 0.08), seed 37), ProgressiveOptions(use_sml_cache=False)",
        "tree.xmfa.bbcols",
    )
    golden["accuracy"] = digest.pair_accuracy(
        interop.interval_list(res.interval_list), truths, [len(g) for g in pg]
    )
    _write("tree_golden.json", golden)


def config1() -> None:
    rng = np.random.default_rng(SEED)
    anc = simulate.random_genome(rng, GENOME_SIZE)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    t0 = time.perf_counter()
    res = MauveAligner(AlignerOptions(use_sml_cache=False)).align([anc, der])
    seconds = time.perf_counter() - t0
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    xmfa = buf.getvalue().encode()
    golden = {
        "config": "bench.py config 1: seed 37, random_genome(1_000_000), "
        "evolve(sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005), "
        "AlignerOptions(use_sml_cache=False)",
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": [
            hashlib.sha256(np.ascontiguousarray(g.codes).tobytes()).hexdigest()
            for g in (anc, der)
        ],
        "genome_lengths": [len(anc), len(der)],
        "n_lcbs": len(res.lcbs),
        "n_anchors": len(res.mums),
        "aligned_columns": int(sum(iv.n_cols for iv in res.interval_list.intervals)),
        "xmfa_sha256": hashlib.sha256(xmfa).hexdigest(),
        "xmfa_bytes": len(xmfa),
    }
    _write("config1_golden.json", golden)
    print(f"config 1: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)


def _repeatoire(spacer_scale: int, name: str, label: str) -> None:
    pg = port_simulate.planted_repeats(spacer_scale)
    g = simulate.Genome(pg.seq.copy(), name=pg.name)
    t0 = time.perf_counter()
    rp = repeatoire.Repeatoire(repeatoire.RepeatoireOptions())
    ml, counts = rp.chain_seed_matches(rp.seed_matches(g), g)
    fams = rp.find_repeats(g, matches=(ml, counts))
    seconds = time.perf_counter() - t0
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256([g]),
        "genome_lengths": [len(g)],
        **digest.repeatoire_digest(repeatoire, write_match_list, g, fams, ml),
    }
    _write(name, golden)
    print(f"{label}: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)


def config4() -> None:
    _repeatoire(1, "config4_golden.json",
                "BASELINE config 4 (scripts/bench_configs.py config4): seed 37, "
                "236 kbp planted-family genome, default RepeatoireOptions, with --seeds")


def config4_big() -> None:
    _repeatoire(4, "config4_big_golden.json",
                "config 4 at bacterial scale: seed 37, every spacer 4x "
                "(926 kbp), default RepeatoireOptions, with --seeds")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*", choices=["1", "3", "tree", "4", "4big"], default=[])
    a = p.parse_args()
    run = {"1": config1, "3": config3, "tree": tree_branch, "4": config4, "4big": config4_big}
    for c in a.configs or list(run):
        run[c]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
