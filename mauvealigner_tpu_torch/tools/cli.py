"""CLI of the port: the mauveAligner subcommand.

Usage:  python -m mauvealigner_tpu_torch.tools mauveAligner a.fa b.fa \\
            --output-alignment=o.xmfa [--device=cuda]
        python -m mauvealigner_tpu_torch.tools --list

Port of the alignment path of mauvealigner_tpu/tools/cli.py's mauveAligner
(src/mauveAligner.cpp): anchoring, LCBs, LCB extension, recursive anchoring,
gapped closure, the match list and the XMFA output.  The other entry points
and outputs of that subcommand are listed in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

from mauvealigner_tpu_torch.tools.common import load_genomes, open_out

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn

    return deco


@tool("mauveAligner")
def mauve_aligner_cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="mauveAligner",
        description="Multi-genome alignment via unique multi-MUM anchoring "
        "(reference: src/mauveAligner.cpp)",
    )
    p.add_argument("seqs", nargs="+", help="sequence files (FASTA/GenBank/raw)")
    p.add_argument("--output", default="-", help="match list output")
    p.add_argument("--output-alignment", default="", help="XMFA output file")
    p.add_argument("--seed-size", type=int, default=0)
    p.add_argument(
        "--seed-type",
        default="spaced",
        choices=["solid", "coding", "spaced", "spaced1", "spaced2"],
    )
    p.add_argument("--weight", type=float, default=None, help="minimum LCB weight")
    p.add_argument("--no-recursion", action="store_true")
    p.add_argument("--no-lcb-extension", action="store_true",
                   help="skip the LCB extension phase")
    p.add_argument("--max-extension-iterations", type=int, default=4,
                   help="LCB extension passes (src/mauveAligner.cpp:879)")
    p.add_argument("--min-recursive-gap-length", type=int, default=200,
                   help="minimum gap size to recurse into (src/mauveAligner.cpp:899)")
    p.add_argument("--no-gapped-alignment", action="store_true")
    p.add_argument("--collinear", action="store_true")
    p.add_argument("--no-nway-filter", action="store_true", help="keep subset matches")
    p.add_argument("--max-gapped-aligner-length", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu the "
                   "plain-torch versions (no fallback between them)")
    p.add_argument("--version", action="version",
                   version="%(prog)s (mauvealigner_tpu_torch)")
    p.add_argument("--debug", action="store_true",
                   help="perform internal consistency checks (very slow)")
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall-clock and GCUPS to stderr")
    a = p.parse_args(argv)

    from mauvealigner_tpu_torch.core import mln
    from mauvealigner_tpu_torch.models.aligner import (
        AlignerOptions,
        AlignmentResult,
        MauveAligner,
    )
    from mauvealigner_tpu_torch.seeds import CODING_SEED, SOLID_SEED

    rank = {"solid": SOLID_SEED, "coding": CODING_SEED, "spaced": 0, "spaced1": 1, "spaced2": 2}[
        a.seed_type
    ]
    genomes = load_genomes(a.seqs)
    opts = AlignerOptions(
        seed_size=a.seed_size,
        seed_rank=rank,
        lcb_weight=a.weight,
        collinear=a.collinear,
        recursive=not a.no_recursion,
        min_recursion_gap=a.min_recursive_gap_length,
        lcb_extension=not a.no_lcb_extension,
        max_extension_iters=a.max_extension_iterations,
        gapped=not a.no_gapped_alignment,
        max_gapped_len=a.max_gapped_aligner_length,
        nway_filter=not a.no_nway_filter,
        debug=a.debug,
        device=a.device,
    )
    aligner = MauveAligner(opts)
    ml = aligner.find_mums(genomes)
    ml, lcbs = aligner.determine_lcbs(genomes, ml)
    if opts.lcb_extension:
        ml, lcbs = aligner.extend_lcbs(genomes, ml, lcbs)
    if opts.recursive:
        ml, lcbs = aligner.recursive_anchor(genomes, ml, lcbs)
    res = AlignmentResult(aligner.build_intervals(genomes, ml, lcbs), lcbs, ml)
    with open_out(a.output) as fh:
        mln.write_match_list(res.mums, fh, a.seqs, [len(g) for g in genomes])
    if a.output_alignment:
        # always XMFA (WriteStandardAlignment, src/mauveAligner.cpp:746-760)
        res.interval_list.seq_filenames = list(a.seqs)
        res.interval_list.write_xmfa(a.output_alignment)
    if a.profile:
        from mauvealigner_tpu_torch.utils import timing

        sys.stderr.write(timing.GLOBAL.report())
    return 0


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("available tools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0
    name = argv[0]
    if name not in TOOLS:
        print(f"unknown tool {name!r}; use --list", file=sys.stderr)
        return 2
    try:
        return TOOLS[name](argv[1:])
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed early — not an error
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
