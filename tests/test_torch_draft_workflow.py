"""Parity of the draft-genome workflow (BASELINE config 5) between the
port on the CPU and the JAX package.

The workflow: a reference and drafts cut into shuffled, partly
reverse-complemented contigs (utils/simulate.draft_genomes, the generator
of scripts/bench_configs.py config5); each draft's anchors against the
reference through MauveAligner(gapped=False, recursive=False), its contigs
placed and oriented by contig_placements_from_lcbs and sort_contigs
(utils/digest.sort_drafts); then ProgressiveMauve of the reference and the
reordered drafts.  At a few kbp, 4 contigs, 3 drafts and seed weight 11,
each draft's placement log, the reordered genomes and the XMFA, .backbone
and .bbcols texts must be identical.  So too with dense contigs (30 kbp cut
into 40, about 750 bp each, some too short to place: the case that drafts
at bacterial length bring), whose front half also runs through both
packages' sort_contigs_sharded over four shards.
"""

import io

import numpy as np
import pytest
import torch

from mauvealigner_tpu_torch.utils import digest, simulate

torch.set_num_threads(1)


def _bench_recipe(n: int, k: int, n_contigs: int):
    """scripts/bench_configs.py config5's generator, as that script writes
    it, on the JAX package's simulate and genome modules."""
    from mauvealigner_tpu.genome.sequence import Contig, Genome, revcomp_ascii
    from mauvealigner_tpu.utils import simulate as jsim

    rng = np.random.default_rng(37)
    ref = jsim.random_genome(rng, n, name="ref")

    def make_draft(evolved, name):
        cuts = np.sort(rng.choice(np.arange(2000, n - 2000), size=n_contigs - 1, replace=False))
        edges = np.concatenate([[0], cuts, [len(evolved)]])
        pieces = []
        for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            chunk = evolved.seq[a:b]
            if rng.random() < 0.4:
                chunk = revcomp_ascii(chunk)
            pieces.append((f"{name}_c{i}", chunk))
        order = rng.permutation(len(pieces))
        contigs, parts, off = [], [], 0
        for idx in order:
            cname, chunk = pieces[idx]
            contigs.append(Contig(cname, len(chunk), off))
            parts.append(chunk)
            off += len(chunk)
        return Genome(np.concatenate(parts), contigs=contigs, name=name)

    drafts = []
    for i in range(k - 1):
        ev, _ = jsim.evolve(ref, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
        drafts.append(make_draft(ev, f"d{i}"))
    return ref, drafts


def _contigs(g):
    return [(c.name, c.length, c.offset) for c in g.contigs]


@pytest.mark.parametrize("shape", [(8000, 4, 4), (20000, 5, 6)])
def test_generator_matches_the_benchmark_recipe(shape):
    """The port's draft_genomes draws what the benchmark's generator draws:
    every genome's bases and contig table."""
    jref, jdrafts = _bench_recipe(*shape)
    ref, drafts = simulate.draft_genomes(*shape)
    assert digest.genome_sha256([ref, *drafts]) == digest.genome_sha256([jref, *jdrafts])
    assert [_contigs(g) for g in [ref, *drafts]] == [_contigs(g) for g in [jref, *jdrafts]]
    assert [g.name for g in drafts] == [g.name for g in jdrafts]


@pytest.mark.parametrize("rates", [(0.01, 0.002, 0.002), (0.08, 0.01, 0.01), (0.3, 0.2, 0.2)])
def test_evolve_matches_the_jax_package(rates):
    """The port's evolve makes the JAX package's draws in the same order:
    the same descendant and truth alignment, and the generator in the same
    state afterwards."""
    from mauvealigner_tpu.utils import simulate as jsim

    rng = np.random.default_rng(37)
    anc = jsim.random_genome(rng, 20_000)
    jrng, prng = np.random.default_rng(), np.random.default_rng()
    jrng.bit_generator.state = prng.bit_generator.state = rng.bit_generator.state
    jder, jtruth = jsim.evolve(anc, jrng, *rates)
    pder, ptruth = simulate.evolve(simulate.Genome(anc.seq.copy()), prng, *rates)
    assert np.array_equal(pder.seq, jder.seq) and pder.seq.dtype == jder.seq.dtype
    ja, pa = jtruth.intervals[0].aln, ptruth.intervals[0].aln
    assert pa.dtype == ja.dtype and np.array_equal(pa, ja)
    assert prng.bit_generator.state == jrng.bit_generator.state


def _workflow(ref, drafts, aligner_mod, manipulate_mod, progressive_mod, timing_mod, **dev):
    reordered, logs = digest.sort_drafts(ref, drafts, aligner_mod, manipulate_mod,
                                         seed_size=11, **dev)
    timing_mod.GLOBAL.reset()
    res = progressive_mod.ProgressiveMauve(progressive_mod.ProgressiveOptions(
        seed_weight=11, use_sml_cache=False, **dev)).align([ref] + reordered)
    branch = "tree" if "tree_progressive" in timing_mod.GLOBAL.phases else "extant"
    return reordered, logs, res, digest.draft_digest(reordered, logs, res, branch, "w.bbcols")


def _to_jax(g):
    from mauvealigner_tpu.genome.sequence import Contig, Genome

    return Genome(g.seq.copy(), contigs=[Contig(c.name, c.length, c.offset)
                                         for c in g.contigs], name=g.name)


def _both(ref, drafts):
    """The workflow through each package once, on the same genomes (the
    JAX package's copied from the port's)."""
    from mauvealigner_tpu.models import aligner as jal
    from mauvealigner_tpu.models import progressive as jprog
    from mauvealigner_tpu.tools import manipulate as jman
    from mauvealigner_tpu.utils import timing as jtiming
    from mauvealigner_tpu_torch.models import aligner as pal
    from mauvealigner_tpu_torch.models import progressive as pprog
    from mauvealigner_tpu_torch.tools import manipulate as pman
    from mauvealigner_tpu_torch.utils import timing as ptiming

    jax_run = _workflow(_to_jax(ref), [_to_jax(d) for d in drafts], jal, jman, jprog, jtiming)
    port_run = _workflow(ref, drafts, pal, pman, pprog, ptiming, device="cpu")
    return jax_run, port_run


@pytest.fixture(scope="module")
def both():
    return _both(*simulate.draft_genomes(8000, 4, 4))


@pytest.fixture(scope="module")
def dense_genomes():
    return simulate.draft_genomes(30_000, 4, 40)


@pytest.fixture(scope="module")
def dense(dense_genomes):
    return _both(*dense_genomes)


def test_placement_logs_identical(both):
    (_, jlogs, _, jd), (_, plogs, _, pd) = both
    assert plogs == jlogs and len(plogs) == 3 and all(len(log) == 4 for log in plogs)
    assert pd["placement_logs"] == jd["placement_logs"]
    assert pd["contigs_placed"] == jd["contigs_placed"] >= 9


def test_reordered_genomes_identical(both):
    (jr, _, _, jd), (pr, _, _, pd) = both
    for a, b in zip(jr, pr):
        assert np.array_equal(a.seq, b.seq) and _contigs(a) == _contigs(b) and a.name == b.name
    assert pd["reordered_sha256"] == jd["reordered_sha256"]


def test_progressive_outputs_identical(both):
    """XMFA (its header naming the multi-contig drafts), .backbone and
    .bbcols byte-identical; every genome's bases accounted for."""
    (_, _, jres, jd), (_, _, pres, pd) = both
    for key in ("branch", "guide_tree", "n_lcbs", "n_intervals", "xmfa_sha256",
                "backbone_sha256", "bbcols_sha256"):
        assert pd[key] == jd[key], key
    assert pd["bases_accounted"] and jd["bases_accounted"]
    jx, px = io.StringIO(), io.StringIO()
    jres.interval_list.write_xmfa(jx)
    pres.interval_list.write_xmfa(px)
    assert px.getvalue() == jx.getvalue()


def test_dense_contigs_identical(dense):
    """40 contigs a draft: placement logs (the unplaced contigs, strand 0,
    in the JAX package's order), reordered genomes and the XMFA, .backbone
    and .bbcols texts identical."""
    (jr, jlogs, jres, jd), (pr, plogs, pres, pd) = dense
    assert plogs == jlogs and all(len(log) == 40 for log in plogs)
    assert any(s == 0 for log in plogs for _, s in log)
    assert pd["contigs_placed"] == jd["contigs_placed"] > 100
    for a, b in zip(jr, pr):
        assert np.array_equal(a.seq, b.seq) and _contigs(a) == _contigs(b)
    assert pd == jd and pd["bases_accounted"]
    jx, px = io.StringIO(), io.StringIO()
    jres.interval_list.write_xmfa(jx)
    pres.interval_list.write_xmfa(px)
    assert px.getvalue() == jx.getvalue()


def test_dense_contigs_sharded_front_half(dense_genomes, dense):
    """sort_contigs_sharded over four shards equals the sequential front
    half and the JAX package's sort_contigs_sharded over four devices."""
    from mauvealigner_tpu.parallel import make_mesh as jax_make_mesh
    from mauvealigner_tpu.parallel import sort_contigs_sharded as jax_sort_contigs_sharded
    from mauvealigner_tpu_torch.parallel import make_mesh, sort_contigs_sharded

    ref, drafts = dense_genomes
    _, (seq_reordered, seq_logs, _, _) = dense
    got = sort_contigs_sharded(ref, drafts, make_mesh(4, device="cpu"), seed_weight=11)
    jgot = jax_sort_contigs_sharded(_to_jax(ref), [_to_jax(d) for d in drafts],
                                    jax_make_mesh(4), seed_weight=11)
    assert [log for _, log in got] == seq_logs
    assert [[(n, int(s)) for n, s in log] for _, log in jgot] == seq_logs
    for (fixed, _), (jfixed, _), want in zip(got, jgot, seq_reordered):
        assert np.array_equal(fixed.seq, want.seq) and _contigs(fixed) == _contigs(want)
        assert np.array_equal(jfixed.seq, want.seq)
