"""Digests of a progressive alignment, a mauveAligner command line or a
repeatoire run, for holding one run to another.

progressive_digest summarizes a ProgressiveMauve result into the fields a
golden file records: which gate branch ran, the guide tree, the LCB and
interval counts and the sha256 of the XMFA, .backbone and .bbcols texts.
pair_accuracy scores every (ancestor, descendant) projection against the
simulation truths.  Both read the result by attribute and write through the
result's own interval list; repeatoire_digest writes through the writers of
the repeatoire module it is given; mauve_aligner_digest reads the files a
mauveAligner command line wrote (CONFIG2_ARGS).  sort_drafts runs the
draft workflow's front half (config 5) with the aligner and manipulate
modules it is given, draft_digest adds its placement logs to the
progressive digest, and draft_cli_digest runs sortContigs and
uniqueMerCount through the command line it is given.  So the same code
digests a result of the JAX package (scripts/make_port_golden.py) and of
the port (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
from typing import Callable, Dict, List, Sequence

import numpy as np

from mauvealigner_tpu_torch.analysis import backbone as bb
from mauvealigner_tpu_torch.analysis.score_alignment import pair_position_maps
from mauvealigner_tpu_torch.analysis.tree import write_newick


def genome_sha256(genomes) -> List[str]:
    return [hashlib.sha256(np.ascontiguousarray(g.codes).tobytes()).hexdigest() for g in genomes]


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def progressive_digest(res, branch: str, bbcols_name: str) -> Dict:
    """res: a ProgressiveResult; branch: "tree" or "extant" (the gate's
    choice, read from the run's timing phases by the caller); bbcols_name:
    the .bbcols file name the XMFA header refers to."""
    ivl = res.interval_list
    n = ivl.n_seqs
    bbuf, cbuf, xbuf = io.StringIO(), io.StringIO(), io.StringIO()
    if len(res.backbone_rows):
        bb.write_backbone_seq_file(res.backbone_rows, bbuf, n)
        bb.write_backbone_cols_file(res.backbone_segments, cbuf)
        ivl.backbone_filename = bbcols_name
    ivl.write_xmfa(xbuf)
    return {
        "branch": branch,
        "guide_tree": write_newick(res.guide_tree),
        "n_lcbs": len(res.lcbs),
        "n_intervals": len(ivl.intervals),
        "xmfa_sha256": _sha(xbuf.getvalue()),
        "backbone_sha256": _sha(bbuf.getvalue()),
        "bbcols_sha256": _sha(cbuf.getvalue()),
    }


def pair_accuracy(ivl, truths, seq_lengths: Sequence[int]) -> List[Dict]:
    """Sensitivity and PPV of every (0, i) projection against truths[i-1]
    (scripts/bench_enterobacteria.py's scoring): a truth-aligned position
    counts as found when the alignment maps it to the same signed
    position."""
    maps = pair_position_maps(ivl, seq_lengths, pairs=[(0, i) for i in range(1, ivl.n_seqs)])
    out = []
    for i, truth in enumerate(truths, start=1):
        cm = pair_position_maps(truth, [seq_lengths[0], seq_lengths[i]])[(0, 1)]
        a = maps[(0, i)]
        tmask = cm != 0
        tp = int(np.sum(tmask & (a == cm)))
        fn = int(tmask.sum()) - tp
        fp = int(np.sum((a != 0) & (a != cm)))
        out.append({"pair": f"0-{i}", "sn": tp / max(tp + fn, 1), "ppv": tp / max(tp + fp, 1)})
    return out


REPEATOIRE_KEYS = ("n_families", "top_multiplicity", "n_seeds", "xmfa_sha256",
                   "xml_sha256", "highest_sha256", "score_out_sha256", "seeds_sha256")


def repeatoire_digest(rp_mod, write_match_list, genome, fams, seeds) -> Dict:
    """rp_mod: a repeatoire module (write_repeats_xmfa, write_repeats_xml,
    write_highest_stats, write_score_out); write_match_list: the same
    package's core.mln.write_match_list; fams: find_repeats' families;
    seeds: the chained seed MatchList (the CLI's --seeds output)."""
    texts = {}
    for key, write in (
        ("xmfa", lambda fh: rp_mod.write_repeats_xmfa(fams, genome, fh)),
        ("xml", lambda fh: rp_mod.write_repeats_xml(fams, genome, fh)),
        ("highest", lambda fh: rp_mod.write_highest_stats(fams, fh)),
        ("score_out", lambda fh: rp_mod.write_score_out(fams, genome, fh)),
        ("seeds", lambda fh: write_match_list(seeds, fh, [genome.name], [len(genome)])),
    ):
        buf = io.StringIO()
        write(buf)
        texts[key] = buf.getvalue()
    return {
        "n_families": len(fams),
        "top_multiplicity": max((f.multiplicity for f in fams), default=0),
        "n_seeds": len(seeds),
        **{f"{k}_sha256": _sha(v) for k, v in texts.items()},
    }


# BASELINE config 2 (scripts/bench_configs.py config2) as a mauveAligner
# command line: three genomes written as g0.fa .. g2.fa, every output the
# digest reads, islands and backbone at 50 (the benchmark's
# simple_find_islands(., 50) and simple_find_backbone(., 50, 50))
CONFIG2_SEQS = ["g0.fa", "g1.fa", "g2.fa"]
CONFIG2_ARGS = [
    *CONFIG2_SEQS, "--output=config2.mln", "--output-alignment=config2.xmfa",
    "--island-size=50", "--island-output=config2.islands", "--backbone-size=50",
    "--backbone-output=config2.backbone", "--id-matrix=config2.id",
    "--permutation-matrix-output=config2.perm",
]
CONFIG2_FILES = {"xmfa": "config2.xmfa", "islands": "config2.islands",
                 "backbone": "config2.backbone", "id_matrix": "config2.id",
                 "permutation": "config2.perm", "matches": "config2.mln"}
CONFIG2_KEYS = ("n_lcbs", "n_anchors", "n_islands", "n_backbone",
                *(f"{k}_sha256" for k in CONFIG2_FILES))


def config1_genomes(simulate_mod, n: int = 1_000_000) -> list:
    """bench.py config 1's genomes from either package's simulate module: an
    n bp ancestor (seed 37) and a descendant at sub 0.01, ins 0.0005, del
    0.0005."""
    rng = np.random.default_rng(37)
    anc = simulate_mod.random_genome(rng, n)
    der, _ = simulate_mod.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    return [anc, der]


def config2_genomes(simulate_mod, n: int = 500_000) -> list:
    """scripts/bench_configs.py config2's genomes from either package's
    simulate module: an n bp ancestor (seed 37), a descendant at sub 0.01
    and one at sub 0.02 (indel 0.001 each), the second inverted over the
    same fifth of the genome at any n (150,000-250,000 at 500 kbp)."""
    rng = np.random.default_rng(37)
    anc = simulate_mod.random_genome(rng, n)
    d1, _ = simulate_mod.evolve(anc, rng, sub_rate=0.01, ins_rate=0.001, del_rate=0.001)
    d2, _ = simulate_mod.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    return [anc, d1, simulate_mod.apply_inversion(d2, n * 3 // 10, n // 2)]


def config3_genomes(simulate_mod, n: int = 250_000, k: int = 9) -> list:
    """scripts/bench_configs.py config3's genomes from either package's
    simulate module: an n bp ancestor (seed 37) and k - 1 descendants at sub
    0.02, indel 0.001."""
    rng = np.random.default_rng(37)
    anc = simulate_mod.random_genome(rng, n)
    genomes = [anc]
    for _ in range(k - 1):
        d, _ = simulate_mod.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        genomes.append(d)
    return genomes


def write_fasta_files(genomes, directory: str, names: Sequence[str]) -> None:
    for g, name in zip(genomes, names):
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(f">{os.path.splitext(name)[0]}\n{g.seq.tobytes().decode()}\n")


def mauve_aligner_digest(directory: str) -> Dict:
    """The config 2 fields of the files a CONFIG2_ARGS command line wrote in
    `directory`: the LCB count (entries of a permutation row), the anchor
    count (the match list's MatchCount), the island count
    (simple_find_islands lines, six fields) and backbone count (rows below
    the header), and each file's sha256."""
    texts = {}
    for key, name in CONFIG2_FILES.items():
        with open(os.path.join(directory, name), "rb") as fh:
            texts[key] = fh.read()
    perm = texts["permutation"].decode().splitlines()
    islands = texts["islands"].decode().splitlines()
    count = [l for l in texts["matches"].decode().splitlines() if l.startswith("MatchCount")]
    return {
        "n_lcbs": len(perm[0].split("\t")) if perm else 0,
        "n_anchors": int(count[0].split()[1]),
        "n_islands": sum(1 for line in islands if len(line.split("\t")) == 6),
        "n_backbone": max(len(texts["backbone"].decode().splitlines()) - 1, 0),
        **{f"{k}_sha256": hashlib.sha256(v).hexdigest() for k, v in texts.items()},
    }


# BASELINE config 5, the draft workflow (scripts/bench_configs.py config5):
# the fields a golden file records beyond progressive_digest's, the first
# three of them the front half's
FRONT_HALF_KEYS = ("placement_logs", "contigs_placed", "reordered_sha256")
DRAFT_KEYS = (*FRONT_HALF_KEYS, "bases_accounted")
# the draft workflows' utils/simulate.draft_genomes(n, k, n_contigs), seed
# 37: config 5 (scripts/bench_configs.py config5), config 5 at 20 drafts and
# config 5 at bacterial length, one contig per 25 kbp in each
DRAFT_SHAPES = {"5": (150_000, 8, 6), "5wide": (500_000, 21, 20),
                "5bacterial": (4_600_000, 21, 184)}
# BASELINE configs 1, 2 and 3 at E. coli length, uncut: each run's genome
# recipe (config1_genomes, config2_genomes, config3_genomes) and its length
BACTERIAL_RECIPES = {"config1_bacterial": (config1_genomes, 4_600_000),
                     "config2_bacterial": (config2_genomes, 4_600_000),
                     "config3_extant_bacterial": (config3_genomes, 4_600_000)}


def bacterial_genomes(name: str, simulate_mod) -> list:
    """The genomes of BACTERIAL_RECIPES[name] from either package's simulate
    module."""
    recipe, n = BACTERIAL_RECIPES[name]
    return recipe(simulate_mod, n)


def bases_accounted(ivl) -> bool:
    """Every genome's bases lie in exactly as many aligned cells as it is
    long (tests/test_draft_workflow.py's check)."""
    return all(
        sum(int(iv.aln[s].sum()) for iv in ivl.intervals if iv.starts[s] != 0) == len(g)
        for s, g in enumerate(ivl.genomes)
    )


def sort_drafts(ref, drafts, aligner_mod, manipulate_mod, **options):
    """The workflow's sequential front half (scripts/bench_configs.py
    config5, front_half_sequential): per draft, a MauveAligner with
    gapped=False, recursive=False, use_sml_cache=False (and `options`)
    finds the anchors of [ref, draft] and its LCBs, and sort_contigs
    reorders and orients the draft's contigs by contig_placements_from_lcbs.
    aligner_mod / manipulate_mod: either package's models.aligner and
    tools.manipulate.  Returns (reordered drafts, placement logs)."""
    reordered, logs = [], []
    for d in drafts:
        al = aligner_mod.MauveAligner(aligner_mod.AlignerOptions(
            gapped=False, recursive=False, use_sml_cache=False, **options))
        ml = al.find_mums([ref, d])
        _, lcbs = al.determine_lcbs([ref, d], ml)
        placements = manipulate_mod.contig_placements_from_lcbs(d, lcbs, draft_seq_index=1)
        fixed, log = manipulate_mod.sort_contigs(d, placements)
        reordered.append(fixed)
        logs.append(log)
    return reordered, logs


def front_half_digest(reordered, logs) -> Dict:
    """The front half's fields: each draft's placement log ([contig name,
    strand], strand 0 for an unplaced contig), the count of placed contigs
    and the sha256 of every reordered draft."""
    return {
        "placement_logs": [[[name, int(strand)] for name, strand in log] for log in logs],
        "contigs_placed": sum(1 for log in logs for _, strand in log if strand != 0),
        "reordered_sha256": genome_sha256(reordered),
    }


def draft_digest(reordered, logs, res, branch: str, bbcols_name: str) -> Dict:
    """progressive_digest of the workflow's ProgressiveMauve result, with
    the front half's fields (front_half_digest) and whether the alignment
    accounts for every base."""
    return {
        **front_half_digest(reordered, logs),
        "bases_accounted": bases_accounted(res.interval_list),
        **progressive_digest(res, branch, bbcols_name),
    }


DRAFT_CLI_KEYS = ("sort_contigs_stdout", "sort_contigs_fasta_sha256", "unique_mer_count")


def draft_cli_digest(cli: Callable[[List[str]], int], ref, draft, directory: str,
                     extra: Sequence[str] = ()) -> Dict:
    """sortContigs of `draft` against `ref` and uniqueMerCount of each,
    through the command line `cli` (either package's tools.cli.main; the
    port's takes --device in `extra`), in `directory`: the FASTA files
    (written by the port's writer, one record per contig) ref.fa and
    draft.fa, sortContigs' printed log and the sha256 of the FASTA it
    writes, and each file's printed unique-mer count."""
    from mauvealigner_tpu_torch.genome.fasta import write_fasta

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli([*argv, *extra])
        if rc != 0:
            raise RuntimeError(f"{argv[0]} returned {rc}")
        return buf.getvalue()

    with contextlib.chdir(directory):
        write_fasta(ref, "ref.fa")
        write_fasta(draft, "draft.fa")
        log = run(["sortContigs", "ref.fa", "draft.fa", "--output=draft.sorted.fa"])
        with open("draft.sorted.fa", "rb") as fh:
            fasta_sha = hashlib.sha256(fh.read()).hexdigest()
        counts = {f: int(run(["uniqueMerCount", f])) for f in ("ref.fa", "draft.fa")}
    return {"sort_contigs_stdout": log, "sort_contigs_fasta_sha256": fasta_sha,
            "unique_mer_count": counts}
