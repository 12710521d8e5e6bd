"""The benchmark's frozen copies held to the program's originals at a
small size: the genome generator, the position-map scorer, the Gotoh
bounds, the profiler's idle arithmetic and the plain Gotoh recurrence."""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from benchmark import roofline, spec, trace
from benchmark.reference import gotoh, xmfa
from benchmark.traffic import generate


def test_evolve_draws_the_program_simulators_divergence():
    from mauvealigner_tpu_torch.utils import simulate

    n, sub, indel = 300_000, 0.02, 0.002
    anc = generate.random_genome(np.random.default_rng(1), n)
    mine, truth = generate.evolve(anc, np.random.default_rng(2), sub, indel, indel)
    theirs, tl = simulate.evolve(simulate.Genome(anc, name="a"), np.random.default_rng(2),
                                 sub_rate=sub, ins_rate=indel, del_rate=indel)
    from mauvealigner_tpu_torch.analysis.score_alignment import pair_position_maps

    their_map = pair_position_maps(tl, [n, len(theirs)])[(0, 1)]
    for m, d in ((truth, mine), (their_map, theirs.seq)):
        kept = m[1:] != 0
        assert abs(kept.mean() - (1 - indel * (1 + generate.MEAN_INDEL))) < 0.003
        same = anc[kept] == d[m[1:][kept] - 1]
        # every truth pair is the same base unless substituted
        assert abs(1 - same.mean() - sub) < 0.003
    assert abs(len(mine) - len(theirs.seq)) < 0.002 * n


def test_inversions_and_drafts_keep_their_truth():
    rng = np.random.default_rng(5)
    genomes, truths = generate.make_descendants(
        rng, 200_000, [{"sub": 0.0, "indel": 0.0, "inversions": 2}])
    anc, d = genomes
    t = truths[0][1:]
    fwd, rev = t > 0, t < 0
    assert rev.sum() > 0
    assert np.array_equal(anc[fwd], d[t[fwd] - 1])
    assert np.array_equal(anc[rev], generate.COMP[d[-t[rev] - 1]])
    ref, draft = generate.make_draft(np.random.default_rng(6), 100_000, 0.0, 0.0, 20, 0.4)
    flat = np.concatenate(draft.seqs)
    p = draft.truth[1:]
    assert (p != 0).all()
    assert np.array_equal(ref[p > 0], flat[p[p > 0] - 1])
    assert np.array_equal(ref[p < 0], generate.COMP[flat[-p[p < 0] - 1]])
    assert sorted(draft.true_rank.tolist()) == list(range(20))


def _aligned(tmp_path, n=30_000):
    from mauvealigner_tpu_torch.tools.cli import main
    from mauvealigner_tpu_torch.utils import simulate

    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, n)
    der, truth = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.002, del_rate=0.002)
    der = simulate.apply_inversion(der, 5000, 9000)
    files = []
    for i, g in enumerate((anc, der)):
        path = str(tmp_path / f"g{i}.fa")
        generate.write_fasta(path, [(f"g{i}", g.seq)])
        files.append(path)
    x = str(tmp_path / "x.xmfa")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["mauveAligner", *files, f"--output={tmp_path}/m.mln",
                     f"--output-alignment={x}", "--device=cpu"]) == 0
    return anc, der, truth, files, x


def test_pair_maps_and_accuracy_equal_the_programs(tmp_path):
    from mauvealigner_tpu_torch.analysis.score_alignment import pair_position_maps
    from mauvealigner_tpu_torch.core.interval import IntervalList
    from mauvealigner_tpu_torch.genome import read_fasta
    from mauvealigner_tpu_torch.utils import digest

    anc, der, truth, files, x = _aligned(tmp_path)
    genomes = [read_fasta(f) for f in files]
    ivl = IntervalList.read_xmfa(x, genomes)
    lens = [len(anc), len(der)]
    theirs = pair_position_maps(ivl, lens)[(0, 1)]
    aln = xmfa.read_xmfa(x)
    mine = xmfa.pair_map(aln.rows_of(0), aln.rows_of(1), lens[0])
    assert np.array_equal(mine, theirs)
    tmap = pair_position_maps(truth, [len(anc), len(truth.genomes[1])])[(0, 1)]
    sn, ppv, _ = xmfa.accuracy([mine], [tmap])
    want = digest.pair_accuracy(ivl, [truth], lens)[0]
    assert (sn, ppv) == (want["sn"], want["ppv"])


def _gotoh_replay():
    path = os.path.join(spec.ROOT, "scripts", "gotoh_replay.py")
    loader = importlib.util.spec_from_file_location("gotoh_replay_under_test", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["gotoh_forward_codes", "gotoh_forward_profiles"])
def test_bounds_equal_gotoh_replays(kernel):
    replay = _gotoh_replay()
    rng = np.random.default_rng(3)
    for side in (16, 256, 4096):
        la = rng.integers(0, side + 1, 50)
        lb = rng.integers(0, side + 1, 50)
        ms, _ = replay.forward_bound(kernel, la, lb)
        assert roofline.forward_bound_s(kernel, la, lb) * 1e3 == pytest.approx(ms, rel=1e-12)
        tb_ms, _ = replay.traceback_bound(np.maximum(la, lb), side, side)
        assert roofline.traceback_bound_s(la, lb, side, side) * 1e3 == pytest.approx(tb_ms, rel=1e-12)


def test_idle_share_is_the_profile_scripts_on_one_stream():
    # one stream: kernels never overlap, so the union is the scripts' sum
    rng = np.random.default_rng(4)
    starts = np.sort(rng.choice(10**7, 200, replace=False)) * 10
    events = [("k", True, int(s), int(s) + int(rng.integers(1, 9)), 0) for s in starts]
    busy = sum(e - s for _, _, s, e, _ in events) / 1e9
    r = trace.reduce_events(events, 0, 10**8 + 100)
    assert r["busy_s"] == pytest.approx(busy, rel=1e-12)
    assert r["window_s"] == pytest.approx((10**8 + 100) / 1e9)
    assert sum(s for _, s in r["idle_gaps"]) == pytest.approx(r["window_s"] - busy)


def test_the_plain_recurrence_scores_as_the_programs():
    from mauvealigner_tpu_torch.ops import dp

    rng = np.random.default_rng(9)
    B, M, N = 40, 24, 30
    la = rng.integers(1, M + 1, B).astype(np.int32)
    lb = rng.integers(1, N + 1, B).astype(np.int32)
    ca = rng.integers(0, 4, (B, M)).astype(np.uint8)
    cb = rng.integers(0, 4, (B, N)).astype(np.uint8)
    theirs, _ = dp.gotoh_forward_codes_ref(
        torch.from_numpy(ca), torch.from_numpy(cb), torch.from_numpy(la), torch.from_numpy(lb),
        torch.from_numpy(dp.HOXD70.copy()), dp.DEFAULT_GAP_OPEN, dp.DEFAULT_GAP_EXTEND)
    A = [np.frombuffer(b"ACGT", np.uint8)[ca[k, :la[k]]] for k in range(B)]
    Bs = [np.frombuffer(b"ACGT", np.uint8)[cb[k, :lb[k]]] for k in range(B)]
    assert np.array_equal(gotoh.best_scores(A, Bs), theirs.double().numpy())
