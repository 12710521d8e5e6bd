"""K4: the 2-state homology-HMM posterior decode in torch ops.

Port of the backbone's path through mauvealigner_tpu/ops/hmm.py (XLA in the
JAX package; replaces libMems' HomologyHMM, src/progressiveMauve.cpp:
226-260): posterior P(Homologous) per alignment column of many pairwise
projections at once, by forward/backward associative scans in probability
space with a renormalization at every combine.

Precision follows the JAX package, which runs under global x64: emission
probabilities are f32, the transition chain, the scans and the posteriors
f64 (the H100 runs FP64 at full rate).  The scan mirrors
jax.lax.associative_scan's odd/even recursion (and its reverse operand
order), so on equal probabilities the posteriors are the same bits.  XLA's
exp on the CPU is not torch's: the exponentiated emission (f32) and
transition (f64) tables can differ by an ulp, which moves posteriors by up
to ~1e-7 (ROADMAP Queue C); the thresholded bits agree on the test inputs.

Ported: pair_rows_state0_gt (the device row path the backbone uses) and
bucketed_decode in modes "threshold0" (the backbone's host symbol path and
repeatoire's extension gate), "posterior0" and "prefix0" (the JAX package's
forward_backward_prefix / _fb_prefix_sym), for 2 states.  The JAX package's
bit packing of the thresholded posteriors is a transfer-size measure and is
dropped: the bools stay on the device until one transfer.  Not ported yet:
the general S-state path and viterbi.
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


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    B, ne = even.shape
    out = torch.empty((B, ne + odd.shape[1]), dtype=even.dtype, device=even.device)
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
    """Inclusive scan of fn over axis 1 of [B, T] tensors, as
    jax.lax.associative_scan(fn, elems, reverse=reverse, axis=1) orders it:
    with reverse the inputs are flipped, scanned and flipped back, so fn
    sees the later element as its left operand."""
    elems = [e.flip(1) for e in elems] if reverse else list(elems)
    out = _scan(fn, elems)
    return [e.flip(1) for e in out] if reverse else out


def _posterior0(a, b, c, d, a00, a01, pad):
    """P(state 0) [B, T] from the chain elements of steps 1..T-1 (four f64
    [B, T-1] lanes) and the normalized step-0 forward values a00, a01."""
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
    post0 = raw0 / torch.clamp(raw0 + raw1, min=FLOOR)
    return torch.where(pad, 0.0, post0)


def _start(e0, e1, init):
    """Normalized forward values of step 0 (f64)."""
    a00 = init[0] * e0[:, 0].double()
    a01 = init[1] * e1[:, 0].double()
    m0 = torch.clamp(torch.maximum(a00, a01), min=FLOOR)
    return a00 / m0, a01 / m0


def _forward_backward_state0(le: torch.Tensor, log_trans, log_init, lengths) -> torch.Tensor:
    """P(state 0) [B, T] (f64) of a 2-state HMM from f32 emission log-probs
    le [B, T, 2]; steps at or beyond `lengths` are padding (emission one,
    posterior 0).  The JAX package's _forward_backward_2state."""
    T = le.shape[1]
    pad_mask = torch.arange(T, device=le.device)[None, :] < lengths[:, None]
    le = torch.where(pad_mask[:, :, None], le, 0.0)
    return emit_posterior0(
        torch.exp(le[:, :, 0]), torch.exp(le[:, :, 1]),
        torch.exp(log_trans), torch.exp(log_init), pad_mask,
    )


def emit_posterior0(e0, e1, trans, init, pad_mask) -> torch.Tensor:
    """_forward_backward_state0 from emission probabilities e0, e1 (f32
    [B, T]), transition probabilities trans [2, 2] and initial probabilities
    init [2] (f64); pad_mask is True on live steps."""
    E0, E1 = e0[:, 1:].double(), e1[:, 1:].double()
    a = trans[0, 0] * E0
    b = trans[0, 1] * E1
    c = trans[1, 0] * E0
    d = trans[1, 1] * E1
    a00, a01 = _start(e0, e1, init)
    return _posterior0(a, b, c, d, a00, a01, ~pad_mask)


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


def bucketed_decode(
    log_emits,            # list of f32 [T_j, 2] emission rows, or (with
                          # emit_table) uint8/int8 [T_j] symbol streams
    log_trans,            # [2, 2]
    log_init,             # [2]
    mode: str,            # "posterior0" | "threshold0" | "prefix0"
    threshold: float = 0.5,
    max_cols: int = 1 << 16,
    mem_budget: int = 1 << 27,
    emit_table=None,      # [2, n_symbols] log emission table; the lookup
                          # runs on the device
    device="cuda",
):
    """Run many variable-length 2-state HMM decodes through the batched
    scan on `device`.  Jobs bucket by power-of-two padded length (at least
    16, at most max_cols; longer jobs must be pre-chunked by the caller) as
    in the JAX package — the scan's tree, and so its rounding, depends on
    the padded length.  Returns a list aligned with `log_emits`:
      posterior0 -> np.float64 [T_j] P(state 0);
      threshold0 -> np.bool_  [T_j] P(state 0) > threshold;
      prefix0    -> int, leading steps with P(state 0) >= threshold."""
    if mode not in ("posterior0", "threshold0", "prefix0"):
        raise ValueError(f"unknown mode {mode!r}")
    lt = torch.as_tensor(np.asarray(log_trans, np.float64), device=device)
    li = torch.as_tensor(np.asarray(log_init, np.float64), device=device)
    S = int(li.shape[0])
    if S != 2:
        raise NotImplementedError("only the 2-state HMM is ported (ROADMAP Queue B, B2)")
    tab = None
    if emit_table is not None:
        tab = torch.as_tensor(np.ascontiguousarray(np.asarray(emit_table, np.float32).T), device=device)
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
            led = torch.from_numpy(le).to(device)
            if tab is not None:
                if int(le.max(initial=0)) >= tab.shape[0]:
                    raise ValueError(
                        f"symbol {int(le.max())} out of range for emission "
                        f"table with {tab.shape[0]} symbols"
                    )
                led = tab[led.long()]
            lend = torch.from_numpy(lengths).to(device)
            post0 = _forward_backward_state0(led, lt, li, lend)
            # the JAX package compares against an f32 threshold here
            thr = float(np.float32(threshold))
            if mode == "prefix0":
                # first live step below the threshold ends the prefix
                iota = torch.arange(Tp, device=post0.device)
                bad = (iota[None, :] < lend[:, None]) & (post0 < thr)
                first_bad = torch.where(bad, iota[None, :], Tp).min(dim=1).values
                res = torch.minimum(first_bad, lend).cpu().numpy()
                for bi, idx in enumerate(chunk):
                    out[idx] = int(res[bi])
                continue
            res = (post0 > thr if mode == "threshold0" else post0).cpu().numpy()
            for bi, idx in enumerate(chunk):
                out[idx] = res[bi, : int(lengths[bi])]
    return out
