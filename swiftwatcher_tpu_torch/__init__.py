"""swiftwatcher-tpu on PyTorch and CUDA.

The counting path of `swiftwatcher_tpu` (RPCA windows with the warm or the
cold-start solver, the fused motion filter, 8-connected labelling, region
tables, host tracking, event classification, CSV export and the CLI)
ported to PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA
C++ for Hopper (`csrc/`).  The JAX package stays the reference; this
package imports nothing of it, and keeps its own copies of the host modules
(`config`, `geometry`, `pipeline.tracking`, `utils.metrics`, `io.export`).

Every entry point takes an explicit `torch.device`; the CLI
(`python -m swiftwatcher_tpu_torch`) runs on the card unless `--device`
says otherwise.
"""
