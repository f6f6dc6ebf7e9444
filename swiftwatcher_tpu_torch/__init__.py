"""swiftwatcher-tpu on PyTorch and CUDA.

The counting main path of `swiftwatcher_tpu` (RPCA windows, the fused
motion filter, 8-connected labelling, region tables, host tracking, event
classification and CSV export) ported to PyTorch, with the TPU's Pallas
kernels rewritten by hand in CUDA C++ for Hopper (`csrc/`).  The JAX package
stays the reference; this package imports no JAX and shares its JAX-free
host modules (`config`, `geometry`, `pipeline.tracking`, `utils.metrics`).

Every entry point takes an explicit `torch.device`.
"""
