"""L5: the pairwise MauveAligner pipeline.

  aligner.py  — MauveAligner: unique multi-MUM anchoring + LCBs + gapped
                closure (src/mauveAligner.cpp doAlignment)
  closure.py  — gapped closure of the inter-anchor regions
  lcb.py      — LCB determination / greedy breakpoint elimination
  subset.py   — sub-genome helpers used by LCB extension
"""
