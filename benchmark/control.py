"""Controls and planted faults: runs that the check must judge not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control lowp|sketch] [--fault <name>] [--device cuda|cpu]

For each seed: the cell's inputs, one sound job of the program (the same
command line the window drives), the reference's judgement of it; then the
same job with the control or the fault installed, and its judgement.  Prints
one JSON line per job with every number compared and its limit.  Set-up is
shared by all seeds, so a dozen seeds and their controls take one process.

Controls (what the configuration states, broken the way a faster version
might be tempted to):
- ``lowp``: the DP and the homology HMM computed in bfloat16 instead of
  float32.  The DP: the
  reference's own Gotoh (reference/gotoh.py) put in the place of the
  program's two DP launches (ops/dp.py _code_pairs_launch and
  _profiles_launch), its arithmetic in bfloat16, its path walked back and
  its score returned.  The HMM: the reference's decode (reference/hmm.py)
  put in the place of the program's (ops/hmm.py pair_rows_state0_gt), on
  the emission table the program hands it, in bfloat16.
- ``sketch``: the anchor search sorting a 1/16 hash sample of the mers (the
  program's own sketched path, matchops.find_multi_mums_device's
  sketch_mod=16) instead of every mer; in the sharded pair search
  (parallel.sharded.find_pair_mums_sharded), which has no such option, the
  same sample of each pair's mers (matchops._sketch_compact).

Faults (the timed path broken underneath):
- ``dp_answer``: every DP answer altered where it is produced: the last
  diagonal step of each path replaced by a gap in each sequence.
- ``dp_half``: half of each DP batch left out: those regions come back
  unaligned.
- ``placement``: every contig placement's strand flipped where it is made.
- ``hmm_answer``: every bit of the homology HMM's decode inverted where it
  is produced.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as run_mod  # noqa: E402
from benchmark import capture, spec  # noqa: E402
from benchmark.reference import gotoh  # noqa: E402
from benchmark.reference import hmm as hmm_ref  # noqa: E402
from benchmark.traffic import generate  # noqa: E402

OP_DIAG, OP_UP, OP_LEFT = 1, 2, 3
_KIND_TO_OP = np.array([OP_DIAG, OP_UP, OP_LEFT], np.uint8)
_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


@contextlib.contextmanager
def patched(owner, attr, wrap):
    """owner.attr replaced by wrap(owner.attr) for the duration."""
    inner = getattr(owner, attr)
    setattr(owner, attr, wrap(inner))
    try:
        yield
    finally:
        setattr(owner, attr, inner)


def _ops_tensors(kinds_list, M, N, scores, device):
    """Paths (start to end, column kinds) -> the launches' outputs: ops
    [B, M+N] end first, counts [B], scores [B]."""
    B = len(kinds_list)
    ops = np.zeros((B, M + N), np.uint8)
    counts = np.zeros(B, np.int32)
    for k, kinds in enumerate(kinds_list):
        ops[k, :len(kinds)] = _KIND_TO_OP[kinds[::-1]]
        counts[k] = len(kinds)
    return (torch.from_numpy(ops).to(device), torch.from_numpy(counts).to(device),
            torch.as_tensor(scores, dtype=torch.float32).to(device))


def _reference_launch(la, lb, M, N, cell_scores, dtype, device):
    la_h, lb_h = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    paths = gotoh.walk(la_h, lb_h, cell_scores, dtype, device)
    score, _ = gotoh._forward(la_h, lb_h, cell_scores, dtype, device, False)
    return _ops_tensors(paths, M, N, score.float().cpu().numpy(), device)


@contextlib.contextmanager
def lowp(dtype=torch.bfloat16):
    from mauvealigner_tpu_torch.ops import dp, hmm

    def codes_launch(inner):
        def launch(ca, cb, la, lb, subst, gap_open, gap_extend, device):
            ca, cb = np.asarray(ca), np.asarray(cb)
            A = [_LETTERS[np.minimum(ca[k, :la[k]], 4)] for k in range(len(la))]
            Bs = [_LETTERS[np.minimum(cb[k, :lb[k]], 4)] for k in range(len(lb))]
            scores = gotoh.code_scores(A, Bs, dtype, device)
            return _reference_launch(la, lb, ca.shape[1], cb.shape[1], scores, dtype, device)
        return launch

    def profiles_launch(inner):
        def launch(pa, pb, la, lb, subst, gap_open, gap_extend, normalize, device):
            M, N = pa.shape[1], pb.shape[1]
            # the recurrence spans the longest problem, not the padded side
            ma, nb = max(int(np.max(la)), 1), max(int(np.max(lb)), 1)
            pa_t, pb_t = np.asarray(pa)[:, :ma], np.asarray(pb)[:, :nb]
            scores = gotoh.profile_scores(pa_t, pb_t, normalize, dtype, device)
            return _reference_launch(la, lb, M, N, scores, dtype, device)
        return launch

    def hmm_launch(inner):
        def decode(rows, ii, jj, table_T, log_trans, log_init, lengths, threshold):
            emit = torch.exp(table_T.float()).cpu().numpy()  # [4 symbols, 2 states]
            bits = hmm_ref.decode_bits(rows.cpu().numpy(), ii.cpu().numpy(), jj.cpu().numpy(),
                                       lengths.cpu().numpy(), threshold, emit, dtype,
                                       rows.device)
            return torch.from_numpy(bits).to(rows.device)
        return decode

    with patched(dp, "_code_pairs_launch", codes_launch), \
            patched(dp, "_profiles_launch", profiles_launch), \
            patched(hmm, "pair_rows_state0_gt", hmm_launch):
        yield


@contextlib.contextmanager
def sketch(mod: int = 16):
    from mauvealigner_tpu_torch import parallel
    from mauvealigner_tpu_torch.ops import matchops
    from mauvealigner_tpu_torch.parallel import sharded

    def search(inner):
        def find(*args, **kwargs):
            kwargs["sketch_mod"] = mod
            return inner(*args, **kwargs)
        return find

    def sampled(concat):
        def entries(smls_dev):
            return matchops._sketch_compact(*concat(smls_dev), mod)
        return entries

    def pair_search(inner):
        def find(*args, **kwargs):
            # each pair's entries are one concatenation of its two mer lists
            with patched(matchops, "_concat_device_smls", sampled):
                return inner(*args, **kwargs)
        return find

    with patched(matchops, "find_multi_mums_device", search), \
            patched(sharded, "find_pair_mums_sharded", pair_search), \
            patched(parallel, "find_pair_mums_sharded", pair_search):
        yield


def _answer_altered(ops, counts):
    """ops are end first: the first diagonal op found becomes up + left."""
    for k in range(len(counts)):
        row = ops[k, :counts[k]]
        hits = np.flatnonzero(row == OP_DIAG)
        if len(hits) and counts[k] < ops.shape[1]:
            p = hits[0]
            ops[k, p + 2:counts[k] + 1] = row[p + 1:counts[k]].copy()
            ops[k, p], ops[k, p + 1] = OP_UP, OP_LEFT
            counts[k] += 1


def _half_left_out(ops, counts):
    """Every other problem of the batch comes back unaligned: all of A's
    bases against gaps, then all of B's."""
    for k in range(0, len(counts), 2):
        row = ops[k, :counts[k]]
        la = int(np.sum((row == OP_DIAG) | (row == OP_UP)))
        lb = int(np.sum((row == OP_DIAG) | (row == OP_LEFT)))
        ops[k, :] = 0
        ops[k, :lb] = OP_LEFT   # end first: B's bases come last
        ops[k, lb:lb + la] = OP_UP
        counts[k] = la + lb


@contextlib.contextmanager
def fault(name: str):
    if name in ("dp_answer", "dp_half"):
        from mauvealigner_tpu_torch.ops import dp

        alter = _answer_altered if name == "dp_answer" else _half_left_out

        def wrap(inner):
            def launch(*args, **kwargs):
                ops, counts, scores = inner(*args, **kwargs)
                ops, counts = ops.cpu().numpy().copy(), counts.cpu().numpy().copy()
                alter(ops, counts)
                dev = scores.device
                return torch.from_numpy(ops).to(dev), torch.from_numpy(counts).to(dev), scores
            return launch

        with patched(dp, "_code_pairs_launch", wrap), patched(dp, "_profiles_launch", wrap):
            yield
        return
    if name == "hmm_answer":
        from mauvealigner_tpu_torch.ops import hmm

        def invert(inner):
            def decode(*args, **kwargs):
                return ~inner(*args, **kwargs)
            return decode

        with patched(hmm, "pair_rows_state0_gt", invert):
            yield
        return
    if name == "placement":
        from mauvealigner_tpu_torch.tools import manipulate

        def flip(inner):
            def place(*args, **kwargs):
                return [(i, -s, p) for i, s, p in inner(*args, **kwargs)]
            return place

        with patched(manipulate, "contig_placements_from_lcbs", flip):
            yield
        return
    raise ValueError(f"unknown fault {name!r}")


def judged_job(cell, inputs, tmp: str, device: str) -> dict:
    """One job of the cell's command line on `inputs`, judged."""
    from mauvealigner_tpu_torch.tools.cli import main as cli_main

    work = cell["workload"]
    out_dir = tempfile.mkdtemp(dir=tmp)
    argv = run_mod.expand(work["command"], inputs, out_dir, cell["chips"]) + [f"--device={device}"]
    outputs = dict(zip(work["outputs"],
                       run_mod.expand(work["outputs"].values(), inputs, out_dir, cell["chips"])))
    buf = io.StringIO()
    captured: dict = {}
    with contextlib.redirect_stdout(buf), capture.recording(work.get("capture", []), captured):
        rc = cli_main(argv)
    if "stdout" in outputs:
        with open(outputs["stdout"], "w") as fh:
            fh.write(buf.getvalue())
    if rc != 0:
        return {"rc": rc, "correct": False}
    checks, report = run_mod.judge(cell, inputs, outputs, device, [{}], captured)
    return {"rc": rc, "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: v for k, (v, _) in checks.items()},
            "limits": {k: lim for k, (_, lim) in checks.items()}, "report": report}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("lowp", "sketch"), default=None)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--genome-length", type=int, default=None)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    for seed in a.seeds:
        inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], seed,
                                      os.path.join(tmp, f"in{seed}"), a.genome_length)
        sound = judged_job(cell, inputs, tmp, a.device)
        print(json.dumps({"seed": seed, "run": "sound", **sound}), flush=True)
        if a.control or a.fault:
            ctx = (lowp() if a.control == "lowp" else sketch() if a.control == "sketch"
                   else fault(a.fault))
            with ctx:
                bad = judged_job(cell, inputs, tmp, a.device)
            print(json.dumps({"seed": seed, "run": a.control or a.fault, **bad}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
