"""Device numerics and presence checks."""

from __future__ import annotations

import torch


def pin_numerics() -> None:
    """Full-f32 matrix products and convolutions (no TF32).

    The counterpart of the JAX package's `Precision.HIGHEST` on the RPCA
    products (swiftwatcher_tpu/ops/rpca.py): the IALM residual test at
    tol=1e-3 needs true f32 accumulation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
