"""Digests of a progressive alignment or a repeatoire run, for holding one
run to another.

progressive_digest summarizes a ProgressiveMauve result into the fields a
golden file records: which gate branch ran, the guide tree, the LCB and
interval counts and the sha256 of the XMFA, .backbone and .bbcols texts.
pair_accuracy scores every (ancestor, descendant) projection against the
simulation truths.  Both read the result by attribute and write through the
result's own interval list; repeatoire_digest writes through the writers of
the repeatoire module it is given.  So the same code digests a result of the
JAX package (scripts/make_port_golden.py) and of the port (chip_smoke.py).
"""

from __future__ import annotations

import hashlib
import io
from typing import Dict, List, Sequence

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
