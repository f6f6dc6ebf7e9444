"""K5: a chunk of label-flood sweeps.

Counterpart of swiftwatcher_tpu/ops/pallas/ccl_sweep.py:sweep_chunk with
f32 labels.  One sweep of an (N, H, W) label batch under its bool
foreground is

    lbl = fg ? min over the 3x3 window of lbl : sentinel

with out-of-frame cells ignored.  The slow path of label_components
(ops/ccl.py) runs it in chunks between convergence checks.

On a CUDA tensor `sweep_chunk` launches csrc/ccl_sweep.cu; on a CPU tensor
it runs `sweep_chunk_reference`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build

# Sweeps per launch that the kernel's shared-memory halo allows.
MAX_SWEEPS = 8


def min_sweep(lbl: torch.Tensor, fg: torch.Tensor, sentinel: float) -> torch.Tensor:
    """One Jacobi sweep: fg ? 3x3 min of lbl (out-of-frame ignored) : sentinel.

    Ignoring out-of-frame cells equals padding with the sentinel, since the
    window always holds the centre, which is <= sentinel."""
    pooled = -F.max_pool2d(-lbl.unsqueeze(1), 3, stride=1, padding=1).squeeze(1)
    return torch.where(fg, pooled, torch.full_like(pooled, sentinel))


def sweep_chunk_reference(
    lbl: torch.Tensor, fg: torch.Tensor, sweeps: int, sentinel: float
) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    for _ in range(sweeps):
        lbl = min_sweep(lbl, fg, sentinel)
    return lbl


def sweep_chunk(
    lbl: torch.Tensor, fg: torch.Tensor, sweeps: int, sentinel: float
) -> torch.Tensor:
    """(N, H, W) f32 labels + bool fg -> labels after `sweeps` sweeps."""
    if lbl.device.type == "cpu":
        return sweep_chunk_reference(lbl, fg, sweeps, sentinel)
    build.check_operand("sweep_chunk", lbl, torch.float32)
    build.check_operand("sweep_chunk", fg, torch.bool, like=lbl)
    if not 1 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sweep_chunk: sweeps must be 1..{MAX_SWEEPS}, got {sweeps}")
    N, H, W = lbl.shape
    if N > 65535:
        raise ValueError(f"sweep_chunk: at most 65535 frames per launch, got {N}")
    out = torch.empty_like(lbl)
    if N == 0:
        return out
    build.launch(
        "ccl_sweep", "swt_sweep_chunk", lbl.device,
        lbl.data_ptr(), fg.data_ptr(), out.data_ptr(), N, H, W, sweeps, float(sentinel),
    )
    sweep_chunk.launches += 1
    return out


sweep_chunk.launches = 0
