"""K5: a chunk of label-flood sweeps.

Counterpart of swiftwatcher_tpu/ops/pallas/ccl_sweep.py:sweep_chunk with
f32 labels.  One sweep of an (N, H, W) label batch under its bool
foreground is

    lbl = fg ? min over the 3x3 window of lbl : sentinel

with out-of-frame cells ignored.  `sweep_chunk` returns the swept labels
and a per-frame "changed" flag: whether any output cell differs from its
input cell.  The slow path of
label_components (ops/ccl.py) runs it in chunks of 4 sweeps between
convergence checks, reading the flag, and with 1 sweep as the convergence
check itself (a frame is settled when one more sweep changes nothing).

On a CUDA tensor `sweep_chunk` launches csrc/ccl_sweep.cu: one launch over
32 x 64 tiles, each staged with a halo of `sweeps` pixels in shared
memory and swept there (csrc/tile_sweep.cuh: sweep k only on the cells
still exact, background skipped, early stop).  A tile without foreground
of its own writes the sentinel without staging.  Every block ORs whether
its output differs from its input into its frame's flag.  On a CPU tensor
it runs `sweep_chunk_reference`.  Labels are at most the sentinel, as on
the slow path's label and rank planes.
"""

from __future__ import annotations

from typing import Tuple

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, same outputs."""
    out = lbl
    for _ in range(sweeps):
        out = min_sweep(out, fg, sentinel)
    return out, (out != lbl).flatten(1).any(dim=1)


def sweep_chunk(
    lbl: torch.Tensor, fg: torch.Tensor, sweeps: int, sentinel: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) f32 labels + bool fg -> (labels after `sweeps` sweeps,
    (N,) bool "changed")."""
    if lbl.device.type == "cpu":
        return sweep_chunk_reference(lbl, fg, sweeps, sentinel)
    build.check_operand("sweep_chunk", lbl, torch.float32)
    build.check_operand("sweep_chunk", fg, torch.bool, like=lbl)
    if not 1 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sweep_chunk: sweeps must be 1..{MAX_SWEEPS}, got {sweeps}")
    N, H, W = lbl.shape
    out = torch.empty_like(lbl)
    changed = torch.empty((N,), dtype=torch.bool, device=lbl.device)
    if N == 0:
        return out, changed
    build.launch(
        "ccl_sweep", "swt_sweep_chunk", lbl.device,
        lbl.data_ptr(), fg.data_ptr(), out.data_ptr(), changed.data_ptr(),
        N, H, W, sweeps, float(sentinel),
    )
    sweep_chunk.launches += 1
    return out, changed


sweep_chunk.launches = 0
