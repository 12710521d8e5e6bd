"""Device compute (PyTorch, CUDA kernels for the Gotoh DP).

K1 merops      — spaced-mer pack + canonicalize
K2 matchops    — multi-way mer merge + multi-MUM enumeration
K3 dp          — affine-gap DP drivers and plain-torch versions
   gotoh_cuda  — hand-written CUDA forward pass and traceback (csrc/gotoh.cu)
"""
