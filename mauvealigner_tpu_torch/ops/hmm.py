"""K4: the homology-HMM posterior decode in torch ops.

Port of mauvealigner_tpu/ops/hmm.py (XLA in the JAX package; replaces
libMems' HomologyHMM, src/progressiveMauve.cpp:226-260): posterior state
probabilities per alignment column of many streams at once, by
forward/backward associative scans in probability space with a
renormalization at every combine.  The 2-state chain (the backbone's
P(Homologous)) runs on four [B, T] lanes; any other state count scans
[B, T, S, S] matrices (forward_backward).

Precision follows the JAX package, which runs under global x64: emission
probabilities are f32, the transition chain, the scans and the posteriors
f64 (the H100 runs FP64 at full rate).  The scan mirrors
jax.lax.associative_scan's odd/even recursion (and its reverse operand
order), so on equal probabilities the posteriors are the same bits.  XLA's
exp on the CPU is not torch's: the exponentiated emission (f32) and
transition (f64) tables can differ by an ulp, which moves posteriors by up
to ~1e-7 (ROADMAP Queue C); the thresholded bits agree on the test inputs.

Ported: forward_backward (any S), pair_rows_state0_gt (the device row path
the backbone uses) and bucketed_decode in modes "threshold0" (the
backbone's host symbol path and repeatoire's extension gate), "posterior0"
and "prefix0" (the JAX package's forward_backward_prefix / _fb_prefix_sym).
Under an ambient mesh (parallel/context.py) bucketed_decode splits each
launch's batch over the mesh's shards.  The S-state combine is a matrix
product whose sum order may differ from XLA's einsum by an ulp; the 2-state
lanes keep the JAX package's bits.  The JAX package's bit packing of the
thresholded posteriors is a transfer-size measure and is dropped: the bools
stay on the device until one transfer.  viterbi (the most-likely state
path, an XLA scan in the JAX package) is a loop over the steps here.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

# the JAX package's renormalization floor, jnp.float32(1e-30), as promoted
FLOOR = float(np.float32(1e-30))


def _combine2(x, y):
    """2-state chain combine: element-wise 2x2 matrix product L @ R over
    four [B, T] entry lanes, renormalized to max 1."""
    xa, xb, xc, xd = x
    ya, yb, yc, yd = y
    ca = xa * ya + xb * yc
    cb = xa * yb + xb * yd
    cc = xc * ya + xd * yc
    cd = xc * yb + xd * yd
    m = torch.clamp(torch.maximum(torch.maximum(ca, cb), torch.maximum(cc, cd)), min=FLOOR)
    return (ca / m, cb / m, cc / m, cd / m)


def _norm_matmul(x, y):
    """S-state chain combine: the (..., S, S) matrix product L @ R,
    renormalized to max 1 (posterior decoding is scale-invariant, so the
    chain runs in probability space as long as every combine rescales)."""
    C = torch.matmul(x[0], y[0])
    m = C.amax(dim=(-2, -1), keepdim=True)
    return [C / torch.clamp(m, min=FLOOR)]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    B, ne = even.shape[:2]
    out = torch.empty((B, ne + odd.shape[1], *even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(fn: Callable, elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """jax.lax.associative_scan's recursion over axis 1: combine adjacent
    pairs, scan the half-size result (the odd outputs), combine those with
    the remaining even inputs, interleave.  log2(T) levels of elementwise
    ops; no loop over columns."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn([e[:, 0 : n - 1 : 2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _scan(fn, list(reduced))
    if n % 2 == 0:
        even = fn([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], reverse: bool = False):
    """Inclusive scan of fn over axis 1 of [B, T, ...] tensors, as
    jax.lax.associative_scan(fn, elems, reverse=reverse, axis=1) orders it:
    with reverse the inputs are flipped, scanned and flipped back, so fn
    sees the later element as its left operand."""
    elems = [e.flip(1) for e in elems] if reverse else list(elems)
    out = _scan(fn, elems)
    return [e.flip(1) for e in out] if reverse else out


def _posterior0(a, b, c, d, a00, a01, pad, both=False):
    """P(state 0) [B, T] from the chain elements of steps 1..T-1 (four f64
    [B, T-1] lanes) and the normalized step-0 forward values a00, a01; with
    both, (P(state 0), P(state 1))."""
    pa, pb, pc, pd = associative_scan(_combine2, (a, b, c, d))
    alphas0 = torch.cat([a00[:, None], a00[:, None] * pa + a01[:, None] * pc], dim=1)
    alphas1 = torch.cat([a01[:, None], a00[:, None] * pb + a01[:, None] * pd], dim=1)
    # backward: scan the TRANSPOSED factors (b and c swapped) in reverse;
    # beta_t = column sums of the transposed suffix product
    sa, sb, sc, sd = associative_scan(_combine2, (a, c, b, d), reverse=True)
    ones = torch.ones((a.shape[0], 1), dtype=torch.float64, device=a.device)
    betas0 = torch.cat([sa + sc, ones], dim=1)
    betas1 = torch.cat([sb + sd, ones], dim=1)
    raw0 = alphas0 * betas0
    raw1 = alphas1 * betas1
    denom = torch.clamp(raw0 + raw1, min=FLOOR)
    post0 = torch.where(pad, 0.0, raw0 / denom)
    if both:
        return post0, torch.where(pad, 0.0, raw1 / denom)
    return post0


def _start(e0, e1, init):
    """Normalized forward values of step 0 (f64)."""
    a00 = init[0] * e0[:, 0].double()
    a01 = init[1] * e1[:, 0].double()
    m0 = torch.clamp(torch.maximum(a00, a01), min=FLOOR)
    return a00 / m0, a01 / m0


def emit_posterior0(e0, e1, trans, init, pad_mask, both=False):
    """P(state 0) [B, T] (f64) of a 2-state HMM (the JAX package's
    _forward_backward_2state) from emission probabilities e0, e1 (f32
    [B, T]), transition probabilities trans [2, 2] and initial probabilities
    init [2] (f64); pad_mask is True on live steps (padding steps carry
    emission one and get posterior 0).  With both, the posteriors of both
    states."""
    E0, E1 = e0[:, 1:].double(), e1[:, 1:].double()
    a = trans[0, 0] * E0
    b = trans[0, 1] * E1
    c = trans[1, 0] * E0
    d = trans[1, 1] * E1
    a00, a01 = _start(e0, e1, init)
    return _posterior0(a, b, c, d, a00, a01, ~pad_mask, both)


def forward_backward(log_emit: torch.Tensor, log_trans, log_init, lengths) -> torch.Tensor:
    """Posterior state probabilities [B, T, S] (f64) from f32 emission
    log-probs [B, T, S], f64 log_trans [S, S] (row = from) and log_init [S];
    steps at or beyond `lengths` are padding (emission one, posterior 0).

    Log-depth associative scans over per-step transition matrices
    A_t[i, j] = trans[i, j] * emit_t[j]: the forward prefix products give
    alpha, the reverse scan of the transposed matrices gives beta.  S = 2
    takes the four-lane route (emit_posterior0), the JAX package's bits."""
    B, T, S = log_emit.shape
    pad_mask = torch.arange(T, device=log_emit.device)[None, :] < lengths[:, None]
    le = torch.where(pad_mask[:, :, None], log_emit, 0.0)
    if S == 2:
        post0, post1 = emit_posterior0(
            torch.exp(le[:, :, 0]), torch.exp(le[:, :, 1]),
            torch.exp(log_trans), torch.exp(log_init), pad_mask, both=True,
        )
        return torch.stack([post0, post1], dim=-1)
    emit = torch.exp(le)                                      # f32, <= 1
    A = torch.exp(log_trans)[None, None] * emit[:, :, None, :].double()
    A_fwd = A[:, 1:]                                          # steps 1..T-1
    (prefix,) = associative_scan(_norm_matmul, [A_fwd])
    alpha0 = torch.exp(log_init) * emit[:, 0].double()
    alpha0 = alpha0 / torch.clamp(alpha0.amax(dim=-1, keepdim=True), min=FLOOR)
    alphas_rest = torch.einsum("bk,btkj->btj", alpha0, prefix)
    alphas = torch.cat([alpha0[:, None, :], alphas_rest], dim=1)
    # beta_t = A_{t+1} ... A_{T-1} 1: a reverse scan composes right to
    # left, so scan the transposed matrices; column sums give beta
    (suffix_T,) = associative_scan(_norm_matmul, [A_fwd.transpose(-1, -2)], reverse=True)
    betas = torch.cat(
        [suffix_T.sum(dim=-2), torch.ones((B, 1, S), dtype=torch.float64, device=A.device)],
        dim=1,
    )
    raw = alphas * betas
    post = raw / torch.clamp(raw.sum(dim=2, keepdim=True), min=FLOOR)
    return torch.where(pad_mask[:, :, None], post, 0.0)


def _fb2_pair_rows_state0(ri, rj, table_T, log_trans, log_init, lengths) -> torch.Tensor:
    """P(state 0) [B, T] (f64) decoded directly from pair code rows.

    ri/rj: uint8 [B, T] per-column base codes (0-3 = A/C/G/T, 4 = N,
    5 = gap/absent) in match-space orientation.  Column symbol classes
    (match / transition / transversion / gap) are computed elementwise.
    Both-gap columns are inert: their chain element is the identity, so the
    posterior there equals the nearest live column's (the projected-pair
    semantics); the first live column's element is diag(e)."""
    return pair_rows_posterior0(
        ri, rj, torch.exp(table_T), torch.exp(log_trans), torch.exp(log_init), lengths
    )


def pair_rows_posterior0(ri, rj, et, trans, init, lengths) -> torch.Tensor:
    """_fb2_pair_rows_state0 from probabilities: et [4, 2] f32 per-symbol
    emission, trans [2, 2] and init [2] f64."""
    B, T = ri.shape
    dev = ri.device
    pad = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
    none = ((ri == 5) & (rj == 5)) | pad
    base = (ri < 4) & (rj < 4)
    match = base & (ri == rj)
    # transitions are A<->G (0^2) and C<->T (1^3): xor == 2
    tr_sym = base & ((ri ^ rj) == 2)

    def emit(state):
        return torch.where(
            match, et[0, state],
            torch.where(tr_sym, et[1, state], torch.where(base, et[2, state], et[3, state])),
        )

    e0 = torch.where(none, 1.0, emit(0))
    e1 = torch.where(none, 1.0, emit(1))
    live = ~none
    first = live & (torch.cumsum(live.to(torch.int32), dim=1) == 1)
    nz, f = none[:, 1:], first[:, 1:]
    E0, E1 = e0[:, 1:].double(), e1[:, 1:].double()
    a = torch.where(nz, 1.0, torch.where(f, E0, trans[0, 0] * E0))
    b = torch.where(nz | f, 0.0, trans[0, 1] * E1)
    c = torch.where(nz | f, 0.0, trans[1, 0] * E0)
    d = torch.where(nz, 1.0, torch.where(f, E1, trans[1, 1] * E1))
    a00, a01 = _start(e0, e1, init)
    return _posterior0(a, b, c, d, a00, a01, pad)


def pair_rows_state0_gt(
    rows: torch.Tensor,       # uint8 [P, T] code rows (shared across pairs)
    ii: torch.Tensor,         # int64 [B] row index of pair member i
    jj: torch.Tensor,         # int64 [B] row index of pair member j
    table_T: torch.Tensor,    # f32 [4, 2] log emission table (symbol-major)
    log_trans: torch.Tensor,  # f64 [2, 2]
    log_init: torch.Tensor,   # f64 [2]
    lengths: torch.Tensor,    # int64 [B]
    threshold: float,
) -> torch.Tensor:
    """bool [B, T]: P(Homologous) > threshold per column for many pairwise
    projections sharing a code-row table (one row upload serves every pair
    containing it); padding columns are False."""
    post0 = _fb2_pair_rows_state0(rows[ii], rows[jj], table_T, log_trans, log_init, lengths)
    return post0 > threshold


def _decode(le, lengths, lt, li, tab, mode: str, thr: float, device):
    """One launch of bucketed_decode on `device`: le is f32 [B, Tp, S]
    emission rows or (with tab) uint8 [B, Tp] symbols, lengths int64 [B]."""
    led = torch.from_numpy(le).to(device)
    if tab is not None:
        led = tab[led.long()]
    lend = torch.from_numpy(lengths).to(device)
    post0 = forward_backward(led, lt, li, lend)[:, :, 0]
    if mode == "prefix0":
        # first live step below the threshold ends the prefix
        Tp = post0.shape[1]
        iota = torch.arange(Tp, device=post0.device)
        bad = (iota[None, :] < lend[:, None]) & (post0 < thr)
        first_bad = torch.where(bad, iota[None, :], Tp).min(dim=1).values
        return torch.minimum(first_bad, lend)
    return post0 > thr if mode == "threshold0" else post0


def bucketed_decode(
    log_emits,            # list of f32 [T_j, S] emission rows, or (with
                          # emit_table) uint8/int8 [T_j] symbol streams
    log_trans,            # [S, S]
    log_init,             # [S]
    mode: str,            # "posterior0" | "threshold0" | "prefix0"
    threshold: float = 0.5,
    max_cols: int = 1 << 16,
    mem_budget: int = 1 << 27,
    emit_table=None,      # [S, n_symbols] log emission table; the lookup
                          # runs on the device
    device="cuda",
):
    """Run many variable-length HMM decodes through the batched scan on
    `device` (on the shards of the ambient mesh, if any: each launch's batch
    is split over them).  Jobs bucket by power-of-two padded length (at
    least 16, at most max_cols; longer jobs must be pre-chunked by the
    caller) as in the JAX package — the scan's tree, and so its rounding,
    depends on the padded length.  Returns a list aligned with `log_emits`:
      posterior0 -> np.float64 [T_j] P(state 0);
      threshold0 -> np.bool_  [T_j] P(state 0) > threshold;
      prefix0    -> int, leading steps with P(state 0) >= threshold."""
    from mauvealigner_tpu_torch.parallel import context as par_ctx

    if mode not in ("posterior0", "threshold0", "prefix0"):
        raise ValueError(f"unknown mode {mode!r}")
    lt = torch.as_tensor(np.asarray(log_trans, np.float64), device=device)
    li = torch.as_tensor(np.asarray(log_init, np.float64), device=device)
    S = int(li.shape[0])
    tab = None
    if emit_table is not None:
        tab = torch.as_tensor(np.ascontiguousarray(np.asarray(emit_table, np.float32).T), device=device)
    # the JAX package compares against an f32 threshold
    thr = float(np.float32(threshold))
    out: list = [None] * len(log_emits)
    buckets: dict = {}
    for idx, le_row in enumerate(log_emits):
        T = len(le_row)
        if T == 0:
            out[idx] = (
                0 if mode == "prefix0"
                else np.zeros(0, bool if mode == "threshold0" else np.float64)
            )
            continue
        if T > max_cols:
            raise ValueError(f"job length {T} exceeds max_cols {max_cols}")
        Tp = 1 << max(4, (T - 1).bit_length())
        buckets.setdefault(Tp, []).append(idx)
    for Tp, idxs in buckets.items():
        cap_rows = max(64, mem_budget // max(Tp * 4 * S, 1))
        for off in range(0, len(idxs), cap_rows):
            chunk = idxs[off : off + cap_rows]
            B = len(chunk)
            lengths = np.zeros(B, np.int64)
            if tab is None:
                le = np.zeros((B, Tp, S), np.float32)
            else:
                le = np.zeros((B, Tp), np.uint8)
            for bi, idx in enumerate(chunk):
                row = log_emits[idx]
                lengths[bi] = len(row)
                le[bi, : len(row)] = row
            if tab is not None and int(le.max(initial=0)) >= tab.shape[0]:
                raise ValueError(
                    f"symbol {int(le.max())} out of range for emission "
                    f"table with {tab.shape[0]} symbols"
                )
            res = par_ctx.shard_batched_call(
                lambda e, n, t, i, tb, device: _decode(e, n, t, i, tb, mode, thr, device),
                [le, lengths], (lt, li, tab), device=device,
            )
            for bi, idx in enumerate(chunk):
                out[idx] = int(res[bi]) if mode == "prefix0" else res[bi, : int(lengths[bi])]
    return out


def viterbi(log_emit: torch.Tensor, log_trans, log_init, lengths) -> torch.Tensor:
    """Most-likely state path [B, T] (int32) from emission log-probs
    [B, T, S], log_trans [S, S] (row = from) and log_init [S]; steps at or
    beyond `lengths` are padding (emission log-prob 0, so they follow the
    transitions from the last live state).

    The JAX package's scan is a loop over the steps here, then the
    backtrace.  torch.argmax, like jnp.argmax, takes the first maximum, so
    ties break alike; dtypes promote as in the JAX package (f32 emissions
    with f64 tables decode in f64)."""
    B, T, S = log_emit.shape
    pad_mask = torch.arange(T, device=log_emit.device)[None, :] < lengths[:, None]
    le = torch.where(pad_mask[:, :, None], log_emit, 0.0)
    delta = log_init[None] + le[:, 0]
    backs = []
    for t in range(1, T):
        scores = delta[:, :, None] + log_trans[None]  # [B, S_from, S_to]
        backs.append(torch.argmax(scores, dim=1))
        delta = scores.amax(dim=1) + le[:, t]
    state = torch.argmax(delta, dim=1)
    path = [state]
    for back in reversed(backs):
        state = torch.gather(back, 1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32)
