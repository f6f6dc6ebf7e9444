"""Device numerics and presence checks."""

from __future__ import annotations

import subprocess

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


def device_from_arg(name: str) -> torch.device:
    """The device a --device argument names; "cuda" is the first card, and
    a CUDA device raises where there is no card (no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        first = require_cuda()
        device = first if device.index is None else device
    return device


def card_line(device) -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
