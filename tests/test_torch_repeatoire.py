"""Slice-5 parity: the port's repeatoire (plain-torch path on the CPU)
against the JAX package on the inputs of tests/test_repeatoire.py, option
by option (family starts, alignments, scores and tandem flags, and the XMFA,
XML, procrast.highest and --score-out texts, byte for byte); the seeding and
chaining phases, the batched extension's building blocks (mixed-arity wave
padding through the closure, the component symbols, the extension segments),
the repeatoire, scoreProcrastAlignment and scoreALU CLIs of both packages,
and progressiveMauve's CLI with the SML disk cache on.  Each package runs
once per input (a module-level cache)."""

import functools
import io

import numpy as np
import pytest
import torch

from mauvealigner_tpu.analysis import repeat_score as jax_repeat_score
from mauvealigner_tpu.genome.sequence import Genome, encode_ascii, revcomp_ascii
from mauvealigner_tpu.models import closure as jax_closure
from mauvealigner_tpu.models import repeatoire as jr
from mauvealigner_tpu.tools.cli import main as jax_cli
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis import repeat_score
from mauvealigner_tpu_torch.models import closure
from mauvealigner_tpu_torch.models import repeatoire as tr
from mauvealigner_tpu_torch.tools.cli import main as torch_cli

torch.set_num_threads(1)


def _with_repeats(rng, n_copies=3, unit_len=120, spacer=300, mutate=0):
    """tests/test_repeatoire.py::_genome_with_repeats."""
    unit = simulate.random_genome(rng, unit_len).seq
    parts = [simulate.random_genome(rng, spacer).seq]
    for _ in range(n_copies):
        copy = unit.copy()
        for _ in range(mutate):
            p = rng.integers(0, unit_len)
            copy[p] = ord("ACGT"[rng.integers(0, 4)])
        parts.append(copy)
        parts.append(simulate.random_genome(rng, spacer).seq)
    return Genome(np.concatenate(parts), name="reps")


def _mutated(rng):
    return _with_repeats(rng, n_copies=4, unit_len=200, mutate=6)


def _inverted(rng):
    unit = simulate.random_genome(rng, 150).seq
    sp = lambda: simulate.random_genome(rng, 200).seq  # noqa: E731
    return Genome(np.concatenate([sp(), unit, sp(), revcomp_ascii(unit), sp()]), name="inv")


def _novel_subsets(rng):
    Y = simulate.random_genome(rng, 300).seq
    X = simulate.random_genome(rng, 250).seq
    sp = lambda: simulate.random_genome(rng, 400).seq  # noqa: E731
    return Genome(np.concatenate([sp(), Y, X, sp(), Y, X, sp(), Y, sp(), Y, sp(), X, sp()]),
                  name="subsets")


def _tandem(rng):
    unit = simulate.random_genome(rng, 150).seq
    parts = [simulate.random_genome(rng, 400).seq] + [unit.copy() for _ in range(3)]
    parts.append(simulate.random_genome(rng, 400).seq)
    return Genome(np.concatenate(parts), name="tandem")


def _novel_match(rng):
    """tests/test_repeatoire.py::test_novel_match_registration: diverged
    suffixes only reachable through a blocking subset segment."""
    unit = simulate.random_genome(rng, 300).seq
    y1 = simulate.random_genome(rng, 200).seq
    codes = encode_ascii(y1)
    codes2 = codes.copy()
    sub = np.arange(3, len(codes), 6)
    codes2[sub] = (codes2[sub] + 1) % 4
    y2 = np.frombuffer(b"ACGT", np.uint8)[codes2]
    sp = lambda: simulate.random_genome(rng, 3000).seq  # noqa: E731
    j1, j2 = simulate.random_genome(rng, 20).seq, simulate.random_genome(rng, 20).seq
    return Genome(np.concatenate([sp(), unit, j1, y1, sp(), unit, j2, y2, sp(), unit, sp()]),
                  name="planted")


# case -> (genome builder, RepeatoireOptions fields)
CASES = {
    "default": (_mutated, dict(z=9)),
    "no_redundant": (_mutated, dict(z=9, allow_redundant=False)),
    "large_repeats": (_mutated, dict(z=9, allow_redundant=False, large_repeats=True)),
    "two_hits": (_mutated, dict(z=9, two_hits=True)),
    "window0": (_mutated, dict(z=9, window=0)),
    "novel_subsets": (_novel_subsets, dict(z=9, find_novel_subsets=True)),
    "no_tandem": (_tandem, dict(z=9, allow_tandem=False)),
    "tandem": (_tandem, dict(z=9)),
    "inverted": (_inverted, dict(z=9)),
    "only_direct": (_inverted, dict(z=9, only_direct=True)),
    "novel_matches": (_novel_match, dict(z=11, min_length=30)),
}


@functools.lru_cache(maxsize=None)
def _run(case):
    """(JAX genome, JAX families, port genome, port families) of a case."""
    build, kw = CASES[case]
    g = build(np.random.default_rng(37))
    ref = jr.Repeatoire(jr.RepeatoireOptions(**kw)).find_repeats(g)
    tg = interop.genome(g)
    got = tr.Repeatoire(tr.RepeatoireOptions(device="cpu", **kw)).find_repeats(tg)
    return g, ref, tg, got


def _texts(mod, fams, genome):
    out = []
    for write in (
        lambda fh: mod.write_repeats_xmfa(fams, genome, fh),
        lambda fh: mod.write_repeats_xml(fams, genome, fh),
        lambda fh: mod.write_highest_stats(fams, fh),
        lambda fh: mod.write_score_out(fams, genome, fh),
    ):
        buf = io.StringIO()
        write(buf)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_families_match_jax(case):
    _, ref, _, got = _run(case)
    assert len(ref) > 0 and len(ref) == len(got)
    for a, b in zip(ref, got):
        assert np.array_equal(a.starts, b.starts)
        assert np.array_equal(a.aln, b.aln)
        assert a.score == b.score
        assert a.tandem == b.tandem


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_texts_match_jax(case):
    g, ref, tg, got = _run(case)
    for a, b in zip(_texts(jr, ref, g), _texts(tr, got, tg)):
        assert len(a) > 0 and a == b


def test_case_inputs_exercise_their_options():
    """The cases reach what they are named for (so parity covers it)."""
    assert any(f.tandem for f in _run("tandem")[3])
    assert not any(f.tandem for f in _run("no_tandem")[3])
    assert any((f.starts < 0).any() for f in _run("inverted")[3])
    assert not any((f.starts < 0).any() for f in _run("only_direct")[3])
    assert any(f.multiplicity == 2 for f in _run("novel_subsets")[3])


def test_seeding_and_chaining_match_jax():
    g = _mutated(np.random.default_rng(37))
    rj = jr.Repeatoire(jr.RepeatoireOptions(z=9))
    rt = tr.Repeatoire(tr.RepeatoireOptions(z=9, device="cpu"))
    tg = interop.genome(g)
    ml_j, ml_t = rj.seed_matches(g), rt.seed_matches(tg)
    assert np.array_equal(ml_j.starts, ml_t.starts)
    assert np.array_equal(ml_j.lengths, ml_t.lengths)
    (cj, nj), (ct, nt) = rj.chain_seed_matches(ml_j, g), rt.chain_seed_matches(ml_t, tg)
    assert len(cj) > 0 and len(cj) < len(ml_j)
    assert np.array_equal(cj.starts, ct.starts)
    assert np.array_equal(cj.lengths, ct.lengths)
    assert np.array_equal(nj, nt)


def test_mixed_arity_wave_padding(rng):
    """An extension wave pads every job with empty regions to the wave's
    largest arity; the padding never enters a merge, so each padded group
    aligns as it does alone, and as in the JAX package."""
    unit = rng.integers(0, 4, size=60).astype(np.int8)
    groups = []
    for k in (1, 2, 3, 5, 9):
        regs = []
        for _ in range(k):
            r = unit[: rng.integers(20, 60)].copy()
            r[rng.integers(0, len(r), size=4)] = rng.integers(0, 4, size=4)
            regs.append(r)
        groups.append(regs)
    groups.append([np.zeros(0, np.int8)] * 2)  # a job whose flanks are all empty
    arity = max(len(g) for g in groups)
    padded = [g + [np.zeros(0, np.int64)] * (arity - len(g)) for g in groups]
    kw = dict(gap_open=-100.0, gap_extend=-20.0, max_len=4096)
    got = closure.hierarchical_align_region_groups(
        padded, closure.balanced_plan(arity), device="cpu", **kw)
    ref = jax_closure.hierarchical_align_region_groups(
        padded, jax_closure.balanced_plan(arity), **kw)
    for g, a, b in zip(groups, ref, got):
        assert np.array_equal(a, b)
        assert not b[len(g):].any()  # padding rows stay empty
        if len(g) > 1:
            alone = closure.hierarchical_align_region_groups(
                [g], closure.balanced_plan(len(g)), device="cpu", **kw)[0]
            assert np.array_equal(b[: len(g)], alone)


def test_wave_above_255_rows_takes_f32_counts(rng, monkeypatch):
    """A family above 255 members (rmax allows 500) merges count profiles
    that no longer fit uint8; its last balanced-plan rounds go through the
    f32 count path, and the alignment equals the JAX package's."""
    unit = rng.integers(0, 4, size=12).astype(np.int8)
    regs = []
    for _ in range(260):
        r = unit[: rng.integers(6, 13)].copy()
        r[rng.integers(0, len(r))] = rng.integers(0, 4)
        regs.append(r)
    dtypes = []
    launch = closure.dp.align_profiles_batch_async

    def spy(pa, *a, **k):
        dtypes.append(pa.dtype)
        return launch(pa, *a, **k)

    monkeypatch.setattr(closure.dp, "align_profiles_batch_async", spy)
    kw = dict(gap_open=-100.0, gap_extend=-20.0, max_len=4096)
    got = closure.hierarchical_align_region_groups(
        [regs], closure.balanced_plan(260), device="cpu", **kw)[0]
    ref = jax_closure.hierarchical_align_region_groups(
        [regs], jax_closure.balanced_plan(260), **kw)[0]
    assert np.float32 in dtypes and np.uint8 in dtypes
    assert np.array_equal(ref, got)


def test_component_symbols_match_jax(rng):
    flanks_list, alns = [], []
    for k, T in ((2, 10), (3, 40), (5, 17), (1, 8), (4, 0)):
        aln = rng.random((k, T)) < 0.8
        alns.append(aln)
        flanks_list.append([rng.integers(0, 5, size=int(r.sum())).astype(np.int8) for r in aln])
    ref = jr._component_symbols_batch(flanks_list, alns)
    got = tr._component_symbols_batch(flanks_list, alns)
    for a, b, f, aln in zip(ref, got, flanks_list, alns):
        assert np.array_equal(a, b)
        assert np.array_equal(tr._component_symbols(f, aln), b)


def test_extension_segments_match_jax(rng):
    for _ in range(40):
        k, T = int(rng.integers(2, 6)), int(rng.integers(0, 30))
        aln = rng.random((k, T)) < 0.8
        hom = rng.random((k, T)) < 0.6
        a = jr.Repeatoire._extension_segments(aln, hom)
        b = tr.Repeatoire._extension_segments(aln, hom)
        assert a[0] == b[0]
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            assert np.array_equal(a[1][0], b[1][0]) and a[1][1:] == b[1][1:]


def test_read_repeats_xmfa_and_scores_match_jax():
    g, ref, tg, got = _run("default")
    text = _texts(tr, got, tg)[0]
    fj = jr.read_repeats_xmfa(io.StringIO(text))
    ft = tr.read_repeats_xmfa(io.StringIO(text))
    assert [f.starts.tolist() for f in fj] == [f.starts.tolist() for f in ft]
    assert all(np.array_equal(a.aln, b.aln) for a, b in zip(fj, ft))
    half = ft[: max(1, len(ft) // 2)]
    sj = jax_repeat_score.score_procrast_alignment(fj, fj[: len(half)])
    st = repeat_score.score_procrast_alignment(ft, half)
    assert (sj.tp, sj.fn, sj.fp) == (st.tp, st.fn, st.fp) and st.tp > 0


def _fasta(path, g):
    path.write_bytes(b">" + g.name.encode() + b"\n" + g.seq.tobytes() + b"\n")
    return str(path)


@pytest.mark.parametrize("seeds", [False, True])
def test_repeatoire_cli_matches_jax(tmp_path, seeds):
    g = _mutated(np.random.default_rng(37))
    seq = _fasta(tmp_path / "g.fa", g)
    outs = {}
    for pkg, cli, extra in (("j", jax_cli, []), ("t", torch_cli, ["--device=cpu"])):
        flags = [f"--sequence={seq}", "--z=9", f"--output={tmp_path}/{pkg}.xmfa",
                 f"--xml={tmp_path}/{pkg}.xml", f"--highest={tmp_path}/{pkg}.highest",
                 f"--score-out={tmp_path}/{pkg}.scores"]
        if seeds:
            flags.append(f"--seeds={tmp_path}/{pkg}.seeds")
        assert cli(["repeatoire", *flags, *extra]) == 0
        outs[pkg] = {ext: (tmp_path / f"{pkg}.{ext}").read_bytes()
                     for ext in ("xmfa", "xml", "highest", "scores")
                     + (("seeds",) if seeds else ())}
    for ext, ref in outs["j"].items():
        assert len(ref) > 0 and ref == outs["t"][ext], ext


def test_score_clis_match_jax(tmp_path, capsys):
    g, ref, tg, got = _run("default")
    correct = tmp_path / "correct.xmfa"
    calc = tmp_path / "calc.xmfa"
    tr.write_repeats_xmfa(got, tg, str(correct))
    tr.write_repeats_xmfa(got[1:], tg, str(calc))
    rm = tmp_path / "rm.out"
    spans = got[0].spans()
    rm.write_text("".join(
        f"100 1.0 0.0 0.0 reps {l} {r} (0) + AluY SINE/Alu 1 50 (0) {i}\n"
        for i, (l, r) in enumerate(spans[:2].tolist())
    ))
    printed = []
    for cli in (jax_cli, torch_cli):
        assert cli(["scoreProcrastAlignment", str(correct), str(calc)]) == 0
        assert cli(["scoreALU", str(calc), str(rm)]) == 0
        printed.append(capsys.readouterr().out)
    assert "sp_truepos" in printed[0] and printed[0] == printed[1]


def _three_way(rng):
    anc = simulate.random_genome(rng, 2500)
    return [anc] + [simulate.evolve(anc, rng, sub_rate=0.02)[0] for _ in range(2)]


def test_progressive_cli_with_sml_cache_matches_jax(rng, tmp_path):
    """progressiveMauve with the cache on (the default) takes the host
    seed-group path in both packages; each writes its cache files beside
    its inputs, and the outputs are byte-identical."""
    genomes = _three_way(rng)
    outs = {}
    for pkg, cli, extra in (("j", jax_cli, []), ("t", torch_cli, ["--device=cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        paths = [_fasta(d / f"g{i}.fa", Genome(g.seq, name=f"g{i}")) for i, g in enumerate(genomes)]
        assert cli(["progressiveMauve", *paths, "--seed-weight=9",
                    f"--output={tmp_path}/{pkg}.xmfa", *extra]) == 0
        assert len(list(d.glob("*.sslist.npz"))) == len(genomes)
        outs[pkg] = {ext: (tmp_path / f"{pkg}.xmfa{ext}").read_bytes()
                     for ext in ("", ".backbone", ".bbcols", ".guide_tree")}
    for ext, ref in outs["j"].items():
        got = outs["t"][ext]
        if ext == "":
            got = got.replace(b"t.xmfa.bbcols", b"j.xmfa.bbcols").replace(
                str(tmp_path / "t").encode(), str(tmp_path / "j").encode())
        assert len(ref) > 0 and ref == got, ext


def test_progressive_cli_disable_cache_writes_no_cache(rng, tmp_path):
    genomes = _three_way(rng)
    paths = [_fasta(tmp_path / f"g{i}.fa", Genome(g.seq, name=f"g{i}"))
             for i, g in enumerate(genomes)]
    assert torch_cli(["progressiveMauve", *paths, "--seed-weight=9", "--disable-cache",
                      "--device=cpu", f"--output={tmp_path}/t.xmfa"]) == 0
    assert not list(tmp_path.glob("*.sslist.npz"))
