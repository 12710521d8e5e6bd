"""Record reference outputs for the PyTorch port's chip check.

Runs the JAX package on the CPU and writes golden files under
mauvealigner_tpu_torch/data/, which chip_smoke.py holds the port to:

  1     config1_golden.json: config 1 (bench.py: two 1 Mbp genomes about
        1% apart, seed 37): the sha256 of both genomes' code arrays, the
        LCB / anchor / aligned-column counts and the sha256 of the XMFA
        text (seconds);
  2     config2_golden.json: BASELINE config 2 as
        scripts/bench_configs.py builds it (a 500 kbp ancestor from seed 37,
        descendants at sub 0.01 and 0.02 with indel 0.001, the second
        inverted over 150,000-250,000), through the mauveAligner command
        line with islands and backbone at 50 (utils/digest.CONFIG2_ARGS):
        genome sha256, the LCB, anchor, island and backbone counts and the
        sha256 of the XMFA, island, backbone, identity-matrix,
        permutation-matrix and match-list files (about a minute);
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
        4x as long (planted_repeats(4), 926 kbp; about 80 s);
  5     config5_golden.json: BASELINE config 5, the draft workflow of
        scripts/bench_configs.py config5 (utils/simulate.draft_genomes: a
        150 kbp reference and 7 drafts of 6 contigs, seed 37): each draft
        through MauveAligner(gapped=False, recursive=False) and sortContigs
        against the reference, then ProgressiveMauve(use_sml_cache=False) of
        the reference and the reordered drafts (utils/digest.sort_drafts):
        genome sha256, each draft's placement log, contigs placed, the
        reordered drafts' sha256 and the progressive digest; plus the
        sortContigs and uniqueMerCount command lines on the reference and
        the first draft (utils/digest.draft_cli_digest);
  5wide config5_wide_golden.json: the same workflow at BASELINE's "20+
        drafts": a 500 kbp reference and 20 drafts of 20 contigs (one
        contig per 25 kbp, config 5's density), without the command lines;
  headline  headline_golden.json: the tree fields at the system's headline
        size, 9 x 4.6 Mbp (enterobacteria_like(4_600_000, 9, 0.08), the
        genomes of scripts/bench_enterobacteria.py), plus the anchor count
        and the JAX run's CPU seconds (about 9 minutes on 8 CPU cores:
        a 1.5 minute genome build, then the run);
  4chrom  config4_chrom_golden.json: the 4big fields on a whole bacterial
        chromosome, every spacer 20x (planted_repeats(20), 4,606,000 bp;
        about 2 minutes);
  5bacterial  config5_bacterial_golden.json: the 5wide fields at bacterial
        length, uncut: a 4.6 Mbp reference and 20 drafts of 184 contigs
        (utils/digest.DRAFT_SHAPES); about 25 minutes on 8 CPU
        cores (a 3 minute genome build, then 22 minutes of the run), peak
        resident set 14.3 GiB.
  1bacterial  config1_bacterial_golden.json: the config 1 fields at E. coli
        length, uncut: two 4.6 Mbp genomes (utils/digest.BACTERIAL_RECIPES);
  2bacterial  config2_bacterial_golden.json: the config 2 fields on three
        4.6 Mbp genomes, the second descendant inverted over
        1,380,000-2,300,000;
  3bacterial  config3_extant_bacterial_golden.json: the config 3 fields on
        9 x 4.6 Mbp, with ProgressiveOptions(tree_progressive=False) (the
        command line's --tree-progressive=0: the extant branch, which the
        default gate does not take at this size), plus the anchor count,
        the n-way coverage of those anchors, and the default gate's reading
        (its 1/16 sketched search's n-way coverage, the threshold, and the
        branch it would take).

The progressive and repeatoire goldens record the JAX run's wall seconds
on the CPU as "jax_cpu_seconds"; the draft and the three E. coli length
goldens also the genome build's seconds ("genome_build_seconds") and the
process's peak resident set ("peak_rss_gib"), and the draft goldens the
front half's seconds ("jax_cpu_front_seconds"; the whole run's seconds
cover both halves).

Usage:  JAX_PLATFORMS=cpu python scripts/make_port_golden.py [1] [2] [3] [tree] [4] [4big]
            [5] [5wide] [headline] [4chrom] [5bacterial] [1bacterial] [2bacterial] [3bacterial]
        (no argument: all fourteen; the full sizes are best run one to a
        process, so that each records its own peak resident set, in the
        background with nohup and a log)
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import resource
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mauvealigner_tpu.core.mln import write_match_list  # noqa: E402
from mauvealigner_tpu.models import repeatoire  # noqa: E402
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner  # noqa: E402
from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions  # noqa: E402
from mauvealigner_tpu.utils import simulate, timing  # noqa: E402
from mauvealigner_tpu_torch import interop  # noqa: E402
from mauvealigner_tpu_torch.models import progressive as port_progressive  # noqa: E402
from mauvealigner_tpu_torch.utils import digest  # noqa: E402
from mauvealigner_tpu_torch.utils import simulate as port_simulate  # noqa: E402

GENOME_SIZE = 1_000_000
HEADLINE_SIZE = 4_600_000
DATA = os.path.join(os.path.dirname(__file__), "..", "mauvealigner_tpu_torch", "data")


def _write(name: str, golden: dict) -> None:
    out = os.path.join(DATA, name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")
    print(json.dumps(golden))


def _progressive(genomes, label: str, bbcols_name: str, **options) -> dict:
    timing.GLOBAL.reset()
    t0 = time.perf_counter()
    res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False, **options)).align(genomes)
    seconds = time.perf_counter() - t0
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256(genomes),
        "genome_lengths": [len(g) for g in genomes],
        "bbcols_name": bbcols_name,
        **digest.progressive_digest(res, branch, bbcols_name),
        "jax_cpu_seconds": seconds,
    }
    print(f"{label}: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)
    return golden, res


def config3() -> None:
    golden, _ = _progressive(
        digest.config3_genomes(simulate),
        "BASELINE config 3 (scripts/bench_configs.py config3): seed 37, "
        "random_genome(250_000) + 8 x evolve(sub_rate=0.02, ins_rate=0.001, "
        "del_rate=0.001), ProgressiveOptions(use_sml_cache=False)",
        "config3.xmfa.bbcols",
    )
    _write("config3_golden.json", golden)


def enterobacteria_golden(size: int, k: int, label: str, bbcols_name: str) -> dict:
    """The tree-branch golden of enterobacteria_like(size, k, 0.08): the
    progressive digest, the anchor count and each (0, i) pair's sn / ppv
    against the simulation truths.  The port's generator gives the same
    genomes as scripts/bench_enterobacteria.build_genomes(size, k, 0.08)."""
    t0 = time.perf_counter()
    pg, truths = port_simulate.enterobacteria_like(size, k, 0.08)
    print(f"genomes built in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    genomes = [simulate.Genome(g.seq.copy(), name=g.name) for g in pg]
    golden, res = _progressive(genomes, label, bbcols_name)
    golden["n_anchors"] = len(res.mums)
    golden["accuracy"] = digest.pair_accuracy(
        interop.interval_list(res.interval_list), truths, [len(g) for g in pg]
    )
    return golden


def tree_branch() -> None:
    _write("tree_golden.json", enterobacteria_golden(
        GENOME_SIZE, 9,
        "9 x 1 Mbp enterobacteria-like (utils/simulate.enterobacteria_like("
        "1_000_000, 9, 0.08), seed 37), ProgressiveOptions(use_sml_cache=False)",
        "tree.xmfa.bbcols"))


def headline() -> None:
    _write("headline_golden.json", enterobacteria_golden(
        HEADLINE_SIZE, 9,
        "BASELINE.md's headline, 9 x 4.6 Mbp enterobacteria-like (utils/simulate."
        "enterobacteria_like(4_600_000, 9, 0.08), seed 37: the genomes of "
        "scripts/bench_enterobacteria.py), ProgressiveOptions(use_sml_cache=False)",
        "headline.xmfa.bbcols"))


def _aligner_golden(genomes, label: str) -> tuple:
    """(golden fields, seconds) of MauveAligner(use_sml_cache=False).align on
    `genomes`, as bench.py runs config 1."""
    t0 = time.perf_counter()
    res = MauveAligner(AlignerOptions(use_sml_cache=False)).align(genomes)
    seconds = time.perf_counter() - t0
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    xmfa = buf.getvalue().encode()
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256(genomes),
        "genome_lengths": [len(g) for g in genomes],
        "n_lcbs": len(res.lcbs),
        "n_anchors": len(res.mums),
        "aligned_columns": int(sum(iv.n_cols for iv in res.interval_list.intervals)),
        "xmfa_sha256": hashlib.sha256(xmfa).hexdigest(),
        "xmfa_bytes": len(xmfa),
    }
    print(f"{label}: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)
    return golden, seconds


def config1() -> None:
    golden, _ = _aligner_golden(
        digest.config1_genomes(simulate, GENOME_SIZE),
        "bench.py config 1: seed 37, random_genome(1_000_000), "
        "evolve(sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005), "
        "AlignerOptions(use_sml_cache=False)")
    _write("config1_golden.json", golden)


def _bacterial_genomes(name: str) -> tuple:
    """(JAX-package genomes, build seconds) of digest.BACTERIAL_RECIPES[name]:
    drawn with the port's simulate module (the same draws as the JAX
    package's, several times faster; tests/test_torch_recipes.py)."""
    t0 = time.perf_counter()
    genomes = [_jax_genome(g) for g in digest.bacterial_genomes(name, port_simulate)]
    build = time.perf_counter() - t0
    print(f"{name}: genomes built in {build:.1f} s", file=sys.stderr)
    return genomes, build


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def config1_bacterial() -> None:
    genomes, build = _bacterial_genomes("config1_bacterial")
    golden, seconds = _aligner_golden(
        genomes,
        "bench.py config 1 at E. coli length, uncut: seed 37, random_genome(4_600_000), "
        "evolve(sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005), "
        "AlignerOptions(use_sml_cache=False)")
    golden.update(genome_build_seconds=build, jax_cpu_seconds=seconds,
                  peak_rss_gib=_peak_rss_gib())
    _write("config1_bacterial_golden.json", golden)


def _mauve_aligner_golden(genomes, label: str, directory: str) -> tuple:
    """(golden fields, seconds) of the JAX mauveAligner command line with
    digest.CONFIG2_ARGS on `genomes`, written as FASTA files in
    `directory`."""
    from mauvealigner_tpu.tools.cli import main as jax_cli

    digest.write_fasta_files(genomes, directory, digest.CONFIG2_SEQS)
    with contextlib.chdir(directory):
        t0 = time.perf_counter()
        if jax_cli(["mauveAligner", *digest.CONFIG2_ARGS]) != 0:
            raise SystemExit(f"{label}: the JAX mauveAligner command line failed")
        seconds = time.perf_counter() - t0
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256(genomes),
        "genome_lengths": [len(g) for g in genomes],
        **digest.mauve_aligner_digest(directory),
    }
    print(f"{label}: reference run took {seconds:.1f} s on the CPU", file=sys.stderr)
    return golden, seconds


def config2() -> None:
    with tempfile.TemporaryDirectory() as d:
        golden, _ = _mauve_aligner_golden(
            digest.config2_genomes(simulate),
            "BASELINE config 2 (scripts/bench_configs.py config2): seed 37, "
            "random_genome(500_000), evolve(sub_rate=0.01) and evolve(sub_rate=0.02) with "
            "ins_rate=del_rate=0.001, the second inverted over 150,000-250,000; "
            "mauveAligner " + " ".join(digest.CONFIG2_ARGS), d)
    _write("config2_golden.json", golden)


def config2_bacterial() -> None:
    genomes, build = _bacterial_genomes("config2_bacterial")
    with tempfile.TemporaryDirectory() as d:
        golden, seconds = _mauve_aligner_golden(
            genomes,
            "BASELINE config 2 at E. coli length, uncut: seed 37, random_genome(4_600_000), "
            "evolve(sub_rate=0.01) and evolve(sub_rate=0.02) with ins_rate=del_rate=0.001, "
            "the second inverted over 1,380,000-2,300,000; mauveAligner "
            + " ".join(digest.CONFIG2_ARGS), d)
    golden.update(genome_build_seconds=build, jax_cpu_seconds=seconds,
                  peak_rss_gib=_peak_rss_gib())
    _write("config2_bacterial_golden.json", golden)


def config3_extant_bacterial() -> None:
    genomes, build = _bacterial_genomes("config3_extant_bacterial")
    golden, res = _progressive(
        genomes,
        "BASELINE config 3 at E. coli length, uncut: seed 37, random_genome(4_600_000) + "
        "8 x evolve(sub_rate=0.02, ins_rate=0.001, del_rate=0.001), "
        "ProgressiveOptions(use_sml_cache=False, tree_progressive=False) "
        "(--tree-progressive=0: the extant branch)",
        "config3_extant_bacterial.xmfa.bbcols", tree_progressive=False)
    golden["n_anchors"] = len(res.mums)
    golden["nway_coverage"] = port_progressive.nway_coverage(res.mums, genomes)
    # the default gate's reading: above 4,000,000 bases in all it decides on
    # a 1/16 mer sketch's n-way coverage
    opts = ProgressiveOptions(use_sml_cache=False)
    t0 = time.perf_counter()
    sketch = ProgressiveMauve(opts).find_matches(genomes, sketch_mod=opts.distance_sketch)
    cov = port_progressive.nway_coverage(sketch, genomes)
    golden["gate"] = {"sketch_mod": opts.distance_sketch, "sketched_nway_coverage": cov,
                      "threshold": opts.tree_progressive_threshold,
                      "auto_branch": "tree" if cov < opts.tree_progressive_threshold else "extant",
                      "jax_cpu_seconds": time.perf_counter() - t0}
    golden.update(genome_build_seconds=build, peak_rss_gib=_peak_rss_gib())
    _write("config3_extant_bacterial_golden.json", golden)


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
        "jax_cpu_seconds": seconds,
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


def config4_chrom() -> None:
    _repeatoire(20, "config4_chrom_golden.json",
                "config 4 on a whole bacterial chromosome: seed 37, every spacer 20x "
                "(4,606,000 bp), default RepeatoireOptions, with --seeds")


def _jax_genome(g):
    """A JAX-package Genome with the port genome's bases and contig table."""
    from mauvealigner_tpu.genome.sequence import Contig, Genome

    return Genome(g.seq.copy(), contigs=[Contig(c.name, c.length, c.offset) for c in g.contigs],
                  name=g.name)


def _draft_workflow(name: str, label: str, shape: str, with_cli: bool) -> None:
    """One draft workflow's golden on digest.DRAFT_SHAPES[shape]'s genomes;
    `{call}` in `label` becomes that draft_genomes call."""
    from mauvealigner_tpu.models import aligner as jax_aligner
    from mauvealigner_tpu.tools import manipulate
    from mauvealigner_tpu.tools.cli import main as jax_cli

    n, k, n_contigs = digest.DRAFT_SHAPES[shape]
    label = label.format(call=f"utils/simulate.draft_genomes({n:_}, {k}, {n_contigs})")
    t0 = time.perf_counter()
    pref, pdrafts = port_simulate.draft_genomes(n, k, n_contigs)
    ref, drafts = _jax_genome(pref), [_jax_genome(d) for d in pdrafts]
    build = time.perf_counter() - t0
    print(f"{label}: genomes built in {build:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    reordered, logs = digest.sort_drafts(ref, drafts, jax_aligner, manipulate)
    front = time.perf_counter() - t0
    timing.GLOBAL.reset()
    res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False)).align([ref] + reordered)
    seconds = time.perf_counter() - t0
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    bbcols_name = name.replace("_golden.json", ".xmfa.bbcols")
    golden = {
        "config": label,
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": digest.genome_sha256([ref] + drafts),
        "genome_lengths": [len(g) for g in [ref] + drafts],
        "bbcols_name": bbcols_name,
        **digest.draft_digest(reordered, logs, res, branch, bbcols_name),
    }
    if with_cli:
        with tempfile.TemporaryDirectory() as d:
            golden["cli"] = digest.draft_cli_digest(jax_cli, pref, pdrafts[0], d)
    golden["genome_build_seconds"] = build
    golden["jax_cpu_front_seconds"] = front
    golden["jax_cpu_seconds"] = seconds
    golden["peak_rss_gib"] = _peak_rss_gib()
    _write(name, golden)
    print(f"{label}: reference run took {seconds:.1f} s on the CPU (front half "
          f"{front:.1f} s)", file=sys.stderr)


def config5() -> None:
    _draft_workflow(
        "config5_golden.json",
        "BASELINE config 5 (scripts/bench_configs.py config5): seed 37, "
        "{call}; per draft MauveAligner("
        "gapped=False, recursive=False, use_sml_cache=False) + sortContigs, then "
        "ProgressiveOptions(use_sml_cache=False) of ref + reordered drafts",
        "5", with_cli=True)


def config5_wide() -> None:
    _draft_workflow(
        "config5_wide_golden.json",
        "config 5 at BASELINE's 20+ drafts: seed 37, {call}, the same workflow (a reference and 20 drafts of 20 "
        "contigs, one per 25 kbp as in config 5)",
        "5wide", with_cli=False)


def config5_bacterial() -> None:
    _draft_workflow(
        "config5_bacterial_golden.json",
        "config 5 at bacterial length: seed 37, {call}, the same workflow (a 4.6 Mbp reference and 20 drafts "
        "of 184 contigs, one per 25 kbp as in config 5), uncut",
        "5bacterial", with_cli=False)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    run = {"1": config1, "2": config2, "3": config3, "tree": tree_branch, "4": config4,
           "4big": config4_big, "5": config5, "5wide": config5_wide, "headline": headline,
           "4chrom": config4_chrom, "5bacterial": config5_bacterial,
           "1bacterial": config1_bacterial, "2bacterial": config2_bacterial,
           "3bacterial": config3_extant_bacterial}
    p.add_argument("configs", nargs="*", choices=list(run), default=[])
    a = p.parse_args()
    for c in a.configs or list(run):
        run[c]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
