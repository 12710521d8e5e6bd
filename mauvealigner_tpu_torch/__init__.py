"""mauvealigner_tpu_torch: the PyTorch / CUDA port of mauvealigner_tpu.

The pairwise MauveAligner main path runs on an NVIDIA GPU (or, with
device="cpu", through the same code with plain torch in place of the CUDA
kernels).  Module paths mirror the JAX package, so each counterpart sits
under the same name:

  genome/, seeds.py, core/{match,interval,validate,mln}.py, models/lcb.py,
  utils/  backend-free NumPy host code, copied from the JAX package
  core/sml.py         K1 driver (mer lists on the device)
  ops/merops.py       K1 spaced-mer packing (torch)
  ops/matchops.py     K2 multi-MUM search (torch) + host extension
  ops/dp.py           K3 drivers and the plain-torch Gotoh forward/traceback
  ops/gotoh_cuda.py   K3 CUDA kernels (csrc/gotoh.cu), built by ops/_build.py
  models/closure.py   gapped closure of pairwise inter-anchor gaps
  models/aligner.py   MauveAligner / AlignerOptions
  tools/              the mauveAligner CLI subcommand
  interop.py          JAX-package host objects -> the port's

This package imports torch and never jax.
"""

__version__ = "0.1.0"

DEFAULT_RANDOM_SEED = 37  # reference: SetTwisterSeed(37), progressiveMauve.cpp:355
