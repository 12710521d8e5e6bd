"""L5/L7: the aligner pipelines.

  aligner.py           — MauveAligner: unique multi-MUM anchoring + LCBs +
                         gapped closure (src/mauveAligner.cpp doAlignment)
  progressive.py       — ProgressiveMauve: guide tree + sum-of-pairs
                         anchoring + homology HMM backbone
                         (src/progressiveMauve.cpp)
  tree_progressive.py  — the consensus ladder up the guide tree
  closure.py           — gapped closure of the inter-anchor regions
  boundary.py, subset.py, refine.py — boundary extension, subset LCBs,
                         window refinement
  lcb.py, anchor_score.py — LCB determination, sum-of-pairs anchor weights
"""
