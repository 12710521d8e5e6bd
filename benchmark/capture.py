"""What the harness records of the program's own state, for the stage
checks that the output files cannot show (reference/dpstage.py,
reference/hmm.py and reference/contigs.py).

In the untimed warm job each recorder keeps host copies of what one
function of the program is handed and returns.  The warm job has the timed
jobs' inputs and writes the same bytes (the run compares every job's
sha256).  In the window the same recorders only count (``counting``): how
many problems and cells each timed job handed its DP and HMM launches and
how many anchors its search (or the sharded pair search) returned, so the
run can hold every timed job's work to the warm job's.  Counting copies
nothing off the device.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _add(counts, key, n) -> None:
    counts[key] = counts.get(key, 0) + int(n)


def _dp(captured, full: bool):
    from mauvealigner_tpu_torch.ops import dp

    def wrap(kind, inner):
        def launch(a, b, la, lb, *args, **kwargs):
            la_h, lb_h = np.array(la, np.int64), np.array(lb, np.int64)
            _add(captured, "work.dp_problems", len(la_h))
            _add(captured, "work.dp_cells", int((la_h * lb_h).sum()))
            fetch = inner(a, b, la, lb, *args, **kwargs)
            if not full:
                return fetch
            normalize = False
            if kind == "profiles":
                normalize = bool(kwargs.get("normalize", args[3] if len(args) > 3 else False))
            call = {"kind": kind, "a": np.array(a), "b": np.array(b), "la": la_h, "lb": lb_h,
                    "normalize": normalize}

            def fetched():
                ops_list, scores = fetch()
                call["ops"] = [np.array(o) for o in ops_list]
                call["scores"] = np.array(scores, np.float64)
                captured.setdefault("dp", []).append(call)
                return ops_list, scores
            return fetched
        return launch

    return [(dp, "align_code_pairs_batch_async", lambda f: wrap("codes", f)),
            (dp, "align_profiles_batch_async", lambda f: wrap("profiles", f))]


def _hmm(captured, full: bool):
    from mauvealigner_tpu_torch.ops import hmm

    def wrap(inner):
        def decode(rows, ii, jj, table_T, log_trans, log_init, lengths, threshold):
            bits = inner(rows, ii, jj, table_T, log_trans, log_init, lengths, threshold)
            _add(captured, "work.hmm_problems", len(ii))
            _add(captured, "work.hmm_columns", int(lengths.sum()))
            if full:
                captured.setdefault("hmm", []).append({
                    "rows": rows.cpu().numpy(), "ii": ii.cpu().numpy(),
                    "jj": jj.cpu().numpy(), "lengths": lengths.cpu().numpy(),
                    "threshold": float(threshold), "bits": bits.cpu().numpy()})
            return bits
        return decode

    return [(hmm, "pair_rows_state0_gt", wrap)]


def _anchor_rows(ml) -> np.ndarray:
    """rows as a match list file has them: length, then each signed start
    (0 where absent, as the program's NO_MATCH)"""
    return np.concatenate([np.asarray(ml.lengths, np.int64)[:, None],
                           np.asarray(ml.starts, np.int64)], 1)


def _find_mums(captured, full: bool):
    from mauvealigner_tpu_torch.models.aligner import MauveAligner

    def wrap(inner):
        def find(self, genomes):
            ml = inner(self, genomes)
            _add(captured, "work.anchors", len(ml.lengths))
            if full:
                captured["anchors"] = _anchor_rows(ml)
            return ml
        return find

    return [(MauveAligner, "find_mums", wrap)]


def _pair_mums(captured, full: bool):
    """The sharded pair search (parallel.sharded.find_pair_mums_sharded):
    its anchors counted over the pairs, and in full one array per draft,
    kept in the order sort_contigs_sharded was handed the drafts, whichever
    seed weight's call searched it (a call outside sort_contigs_sharded
    appends its drafts in its own order).  Both functions are wrapped where
    the package exports them too."""
    from mauvealigner_tpu_torch import parallel
    from mauvealigner_tpu_torch.parallel import sharded

    open_sorts: list = []  # per sort_contigs_sharded call in progress: (its drafts, their rows)

    def wrap_sort(inner):
        def sort(ref, drafts, *args, **kwargs):
            open_sorts.append((list(drafts), [None] * len(drafts)))
            try:
                out = inner(ref, drafts, *args, **kwargs)
            finally:
                _, rows = open_sorts.pop()
            if full:
                captured.setdefault("pair_anchors", []).extend(rows)
            return out
        return sort

    def wrap_find(inner):
        def find(ref, drafts, *args, **kwargs):
            mls = inner(ref, drafts, *args, **kwargs)
            _add(captured, "work.anchors", sum(len(ml.lengths) for ml in mls))
            if full:
                for d, ml in zip(drafts, mls):
                    if open_sorts:
                        given, rows = open_sorts[-1]
                        rows[next(i for i, g in enumerate(given) if g is d)] = _anchor_rows(ml)
                    else:
                        captured.setdefault("pair_anchors", []).append(_anchor_rows(ml))
            return mls
        return find

    return [(owner, attr, wrap) for owner in (sharded, parallel)
            for attr, wrap in (("sort_contigs_sharded", wrap_sort),
                               ("find_pair_mums_sharded", wrap_find))]


RECORDERS = {"dp": _dp, "hmm": _hmm, "find_mums": _find_mums, "pair_mums": _pair_mums}


@contextlib.contextmanager
def recording(names, captured: dict, full: bool = True):
    """Record what `names` (keys of RECORDERS) see into `captured`; with
    full=False only count it (the "work.*" keys)."""
    patches = [p for name in names for p in RECORDERS[name](captured, full)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, wrap in patches:
            setattr(owner, attr, wrap(getattr(owner, attr)))
        yield captured
    finally:
        for owner, attr, inner in reversed(saved):
            setattr(owner, attr, inner)


def work_of(captured: dict, counters: dict) -> dict:
    """A job's work: the recorders' counts and the program's counters that
    count things rather than seconds (every key not ending in "_s")."""
    out = {k: v for k, v in captured.items() if k.startswith("work.")}
    out.update({k: v for k, v in counters.items() if not k.endswith("_s")})
    return out
