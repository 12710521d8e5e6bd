"""K4 parity: the port's 2-state homology-HMM decode in torch ops against
the JAX package's XLA programs on the CPU.

- The associative scan mirrors jax.lax.associative_scan: the same bits on
  the same inputs, forward and reverse, odd and even lengths.
- Fed the same probabilities (the JAX side's exp of the log tables), the
  posteriors agree within 1e-12 (they are in fact the same bits).
- End to end each package exponentiates its own log tables, and XLA's exp
  on the CPU differs from torch's by an ulp on some entries (f32 emissions,
  f64 transitions): posteriors then agree within 1e-6 (ROADMAP Queue C) and
  the thresholded bits are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mauvealigner_tpu.analysis import backbone as jax_bb
from mauvealigner_tpu.ops import hmm as jax_hmm
from mauvealigner_tpu.utils import simulate as jax_simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis import backbone as bb
from mauvealigner_tpu_torch.ops import hmm

torch.set_num_threads(1)

SAME_INPUT_TOL = 1e-12
END_TO_END_TOL = 1e-6


def _params(gc=0.45):
    return jax_bb.adapted_params(gc)


@pytest.mark.parametrize("T", [1, 2, 7, 16, 37, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_same_bits(rng, T, reverse):
    x = [rng.random((3, T)) for _ in range(4)]
    ref = jax.lax.associative_scan(
        jax_hmm._combine2, tuple(jnp.asarray(v) for v in x), axis=1, reverse=reverse
    )
    got = hmm.associative_scan(hmm._combine2, [torch.from_numpy(v) for v in x], reverse=reverse)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def _pair_rows(rng, P=6, T=320, B=8):
    # T a multiple of 8: the JAX package bit-packs its thresholded output
    rows = rng.integers(0, 6, (P, T)).astype(np.uint8)
    rows[:, 100:140] = 5  # a both-gap stretch: inert columns
    rows[: P // 2, 200:230] = rng.integers(0, 4, (P // 2, 30))  # related rows
    rows[P // 2 :, 200:230] = rows[: P // 2, 200:230]
    ii = rng.integers(0, P, B).astype(np.int64)
    jj = (ii + 1 + rng.integers(0, P - 1, B)) % P
    lens = rng.integers(1, T + 1, B).astype(np.int64)
    lens[0] = T
    return rows, ii, jj, lens


def test_pair_rows_same_probabilities_same_posteriors(rng):
    p = _params()
    lt, li = p.log_trans(), np.log([0.5, 0.5])
    tab = p.log_emit_table().astype(np.float32).T
    rows, ii, jj, lens = _pair_rows(rng)
    ref = np.asarray(jax_hmm._fb2_pair_rows_state0(
        jnp.asarray(rows)[ii], jnp.asarray(rows)[jj], jnp.asarray(tab),
        jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lens),
    ))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = hmm.pair_rows_posterior0(
        t(rows)[t(ii)], t(rows)[t(jj)], t(np.asarray(jnp.exp(jnp.asarray(tab)))),
        t(np.asarray(jnp.exp(jnp.asarray(lt)))), t(np.asarray(jnp.exp(jnp.asarray(li)))),
        t(lens),
    ).numpy()
    assert ref.dtype == got.dtype == np.float64
    assert np.abs(ref - got).max() <= SAME_INPUT_TOL


def test_pair_rows_state0_gt_bits_equal(rng):
    p = _params()
    lt, li = p.log_trans(), np.log([0.5, 0.5])
    tab = p.log_emit_table().astype(np.float32).T
    rows, ii, jj, lens = _pair_rows(rng)
    T = rows.shape[1]
    packed = jax_hmm.pair_rows_state0_gt(
        jnp.asarray(rows), jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(tab),
        jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lens), jnp.asarray(0.5),
    )
    ref = np.unpackbits(np.asarray(packed), axis=1, bitorder="little").astype(bool)[:, :T]
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = hmm.pair_rows_state0_gt(
        t(rows), t(ii), t(jj), t(tab), t(lt), t(li), t(lens), 0.5
    ).numpy()
    assert np.array_equal(ref, got)
    post_ref = np.asarray(jax_hmm._fb2_pair_rows_state0(
        jnp.asarray(rows)[ii], jnp.asarray(rows)[jj], jnp.asarray(tab),
        jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lens),
    ))
    post = hmm._fb2_pair_rows_state0(
        t(rows)[t(ii)], t(rows)[t(jj)], t(tab), t(lt), t(li), t(lens)
    ).numpy()
    assert np.abs(post_ref - post).max() <= END_TO_END_TOL


def test_emission_decode_same_probabilities_same_posteriors(rng):
    p = _params(0.5)
    lt, li = p.log_trans(), np.log([0.5, 0.5])
    B, T = 5, 64
    le = np.log(rng.dirichlet(np.ones(2), size=(B, T)).astype(np.float32))
    lens = np.array([64, 1, 17, 40, 63], np.int64)
    ref = np.asarray(jax_hmm.forward_backward(
        jnp.asarray(le), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lens)
    ))[:, :, 0]
    pad = np.arange(T)[None, :] < lens[:, None]
    e = np.asarray(jnp.exp(jnp.where(jnp.asarray(pad)[:, :, None], jnp.asarray(le), 0.0)))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = hmm.emit_posterior0(
        t(e[:, :, 0]), t(e[:, :, 1]), t(np.asarray(jnp.exp(jnp.asarray(lt)))),
        t(np.asarray(jnp.exp(jnp.asarray(li)))), t(pad),
    ).numpy()
    assert np.abs(ref - got).max() <= SAME_INPUT_TOL


@pytest.mark.parametrize("mode", ["threshold0", "posterior0", "prefix0"])
def test_bucketed_decode_matches_jax(rng, mode):
    p = _params()
    lt, li = p.log_trans(), np.log([0.5, 0.5])
    syms = [rng.integers(0, 4, n).astype(np.uint8) for n in (0, 5, 16, 17, 300, 1000)]
    syms[4][100:160] = 0  # a run of matches
    ref = jax_hmm.bucketed_decode(syms, lt, li, mode, emit_table=p.log_emit_table())
    got = hmm.bucketed_decode(syms, lt, li, mode, emit_table=p.log_emit_table(), device="cpu")
    if mode == "prefix0":
        assert got == ref and all(type(g) is int for g in got)
        return
    for r, g in zip(ref, got):
        assert len(r) == len(g)
        if mode == "threshold0":
            assert g.dtype == bool and np.array_equal(r, g)
        elif len(r):
            assert np.abs(np.asarray(r, np.float64) - g).max() <= END_TO_END_TOL


def test_bucketed_decode_refuses_unported_modes():
    """Every mode of the JAX package is ported now; an unknown one raises."""
    with pytest.raises(ValueError, match="viterbi"):
        hmm.bucketed_decode([np.zeros(4, np.uint8)], np.zeros((2, 2)), np.zeros(2), "viterbi",
                            emit_table=np.zeros((2, 4)), device="cpu")


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
def test_prefix0_counts_match_jax(rng, threshold):
    """prefix0 on repeatoire-like symbol streams (homologous heads, then
    unrelated tails) and on float emission rows, at several thresholds."""
    p = _params()
    lt, li = p.log_trans(), np.log([0.9, 0.1])
    syms = []
    for n in (1, 7, 16, 33, 80, 200, 513):
        s = rng.integers(0, 4, n).astype(np.uint8)
        s[: n // 2] = np.where(rng.random(n // 2) < 0.9, 0, 3)
        syms.append(s)
    ref = jax_hmm.bucketed_decode(syms, lt, li, "prefix0", threshold=threshold,
                                  emit_table=p.log_emit_table())
    got = hmm.bucketed_decode(syms, lt, li, "prefix0", threshold=threshold,
                              emit_table=p.log_emit_table(), device="cpu")
    assert got == ref
    assert len(set(got)) > 2  # prefixes of several lengths
    emits = [np.asarray(p.log_emit_table()).T[s].astype(np.float32) for s in syms]
    ref = jax_hmm.bucketed_decode(emits, lt, li, "prefix0", threshold=threshold)
    got = hmm.bucketed_decode(emits, lt, li, "prefix0", threshold=threshold, device="cpu")
    assert got == ref


def _three_way_intervals(rng):
    from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions

    anc = jax_simulate.random_genome(rng, 3000)
    genomes = [anc] + [jax_simulate.evolve(anc, rng, sub_rate=0.05, ins_rate=0.004,
                                           del_rate=0.004)[0] for _ in range(2)]
    res = ProgressiveMauve(ProgressiveOptions(
        seed_weight=9, use_sml_cache=False, skip_backbone=True
    )).align(genomes)
    return res.interval_list


@pytest.mark.parametrize("device_symbols", [True, False])
def test_detect_backbone_matches_jax(rng, device_symbols):
    """The port's one posterior path of detect_backbone gives the segments
    of both JAX paths (device code rows, host symbol streams) on a 3-way
    alignment."""
    ivl = _three_way_intervals(rng)
    p = _params(jax_bb.compute_gc(ivl.genomes))
    ref = jax_bb.detect_backbone(ivl, p, 20, device_symbols=device_symbols)
    got = bb.detect_backbone(interop.interval_list(ivl), interop.hmm_params(p), 20,
                             device="cpu")
    key = lambda s: (s.interval_index, s.col_start, s.col_end, list(s.seqs))  # noqa: E731
    assert len(ref) > 0 and [key(s) for s in ref] == [key(s) for s in got]


def _viterbi_inputs(rng, B, T, S, tied):
    if tied:
        # integer log-probs on a coarse grid: many equal path scores, so
        # both packages must take the first maximum at every argmax
        le = rng.integers(-2, 1, (B, T, S)).astype(np.float32)
        lt = np.full((S, S), -1.0)
        li = np.zeros(S)
    else:
        le = np.log(rng.dirichlet(np.ones(S), (B, T))).astype(np.float32)
        lt = np.log(rng.dirichlet(np.ones(S) * 2, S) * 0.2 + np.eye(S) * 0.8)
        li = np.log(np.full(S, 1.0 / S))
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    return le, lt, li, lens


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("tied", [False, True])
def test_viterbi_matches_jax(rng, S, tied):
    """The most-likely path equals the JAX package's viterbi exactly (int32,
    padding steps included), ragged lengths, with and without ties."""
    le, lt, li, lens = _viterbi_inputs(rng, 6, 37, S, tied)
    ref = np.asarray(jax_hmm.viterbi(jnp.asarray(le), jnp.asarray(lt), jnp.asarray(li),
                                     jnp.asarray(lens)))
    got = hmm.viterbi(*(torch.from_numpy(x) for x in (le, lt, li, lens)))
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1
