"""Opt-in electronic image stabilisation for jittery footage.

Counterpart of swiftwatcher_tpu/ops/stabilize.py (plain XLA there, no
Pallas kernel), as torch ops on the caller's device.  The reference's RPCA
background assumes a static scene, so camera shake turns every edge into
"motion".  stabilize_window aligns each frame of a window to a reference
pose by an exhaustive integer-shift search:

  1. the reference R: in the pipeline, the gray crop of the frame the ROI
     mask is built from (pipeline/runner.py), so the mask and every
     window's centroids share one pose; without one, each window's
     rounded temporal mean;
  2. for every candidate shift (dy, dx) in [-J, J]^2, the SAD of the frame's
     slice of an edge-padded copy against R, in integers;
  3. each frame becomes its argmin candidate (ties go to the lower
     candidate index), by a masked select over the same slices.

All arithmetic is in integers, so the scores and the choice are exact in
any summation order: the card and the CPU give the same bytes, and so
does the JAX package.  Off by default (config.stabilize_max_shift = 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _edge_pad(gray: torch.Tensor, J: int) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2J, W + 2J), the edge rows and columns
    repeated, by clamped indices (replicate padding is not defined for u8
    on every backend)."""
    H, W = gray.shape[-2:]
    rows = torch.arange(-J, H + J, device=gray.device).clamp_(0, H - 1)
    cols = torch.arange(-J, W + J, device=gray.device).clamp_(0, W - 1)
    return gray.index_select(-2, rows).index_select(-1, cols)


def stabilize_window(
    gray: torch.Tensor, max_shift: int, ref: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align (..., T, H, W) uint8 frames to a reference pose.

    ref: an (H, W) uint8 or int32 reference image; None takes each
    window's rounded temporal mean.  Returns (aligned u8, shifts int32),
    where shifts[..., t] = (dy, dx) is the chosen displacement:
    aligned[t, y, x] = edgepad(gray)[t, y + dy + J, x + dx + J].  J = 0
    returns the input unchanged."""
    if max_shift <= 0:
        return gray, torch.zeros((*gray.shape[:-2], 2), dtype=torch.int32, device=gray.device)
    J = int(max_shift)
    n = 2 * J + 1
    H, W = gray.shape[-2:]
    if ref is None:
        T = gray.shape[-3]
        # round-half-up integer mean, (..., 1, H, W)
        ref = torch.div(gray.to(torch.int32).sum(-3, keepdim=True) * 2 + T, 2 * T,
                        rounding_mode="floor")
    else:
        ref = ref.to(device=gray.device, dtype=torch.int32)
    padded = _edge_pad(gray, J)

    # one candidate plane at a time (all of them at once would take
    # (2J+1)^2 int32 copies of the batch); keep only the SAD sums
    sads = torch.stack([
        (padded[..., a : a + H, b : b + W].to(torch.int32) - ref).abs_().sum((-2, -1))
        for a in range(n) for b in range(n)
    ])                                                      # (C, ..., T)
    # argmin with ties to the lowest candidate index, independent of how a
    # backend's argmin breaks ties
    index = torch.arange(n * n, device=gray.device).reshape(-1, *[1] * (sads.dim() - 1))
    best = torch.where(sads == sads.min(0).values, index, n * n).min(0).values  # (..., T)

    out = torch.zeros_like(gray)
    for c in range(n * n):
        a, b = divmod(c, n)
        out = torch.where((best == c)[..., None, None], padded[..., a : a + H, b : b + W], out)
    shifts = torch.stack([best // n - J, best % n - J], dim=-1).to(torch.int32)
    return out, shifts
