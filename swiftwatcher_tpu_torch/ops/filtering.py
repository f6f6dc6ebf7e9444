"""Per-frame motion post-filters: bilateral blur, threshold-to-zero, opening.

Counterpart of swiftwatcher_tpu/ops/filtering.py, bit-equal to it:

  * the bilateral is cv2's circular d=7 neighbourhood on a BORDER_REFLECT_101
    pad, with f32 weights sw * exp(d^2 * gc), taps accumulated in the order
    of `bilateral_offsets`, and round half to even;
  * threshold-to-zero keeps values strictly above the threshold;
  * the grey opening is erosion then dilation with edge replication.

Frames are batch-first: (..., H, W) uint8.  `apply_postfilter` is the gate
that sends CUDA frames to the fused kernel K1 (ops/fused_motion.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig


def bilateral_offsets(radius: int) -> Tuple[Tuple[int, int, float], ...]:
    """Circular neighbourhood offsets (i, j, r^2), in cv2's scan order."""
    offs = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(i * i + j * j)
            if r > radius:
                continue
            offs.append((i, j, r * r))
    return tuple(offs)


def bilateral_constants(d: int, sigma_color: float, sigma_space: float):
    """(radius, per-tap f32 space weights, f32 colour coefficient), with the
    rounding of the JAX package: each weight is exp() in double, rounded
    once to f32."""
    radius = max(d // 2, 1)
    gauss_space = -0.5 / (sigma_space * sigma_space)
    space = [
        float(np.float32(math.exp(r2 * gauss_space)))
        for _, _, r2 in bilateral_offsets(radius)
    ]
    gauss_color = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    return radius, space, gauss_color


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    k = torch.arange(-pad, n + pad, device=device)
    k = torch.where(k < 0, -k, k)
    return torch.where(k >= n, 2 * n - 2 - k, k)


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)


def bilateral_blur(
    frames: torch.Tensor,
    d: int = 7,
    sigma_color: float = 15.0,
    sigma_space: float = 1.0,
) -> torch.Tensor:
    """cv2.bilateralFilter-parity bilateral blur over (..., H, W) uint8."""
    radius, space, gc = bilateral_constants(d, sigma_color, sigma_space)
    H, W = frames.shape[-2], frames.shape[-1]
    x = frames.reshape(-1, H, W)
    iy = _reflect101_index(H, radius, x.device)
    ix = _reflect101_index(W, radius, x.device)
    padded = x[:, iy][:, :, ix].to(torch.float32)
    center = x.to(torch.float32)
    num = torch.zeros_like(center)
    den = torch.zeros_like(center)
    for (i, j, _), sw in zip(bilateral_offsets(radius), space):
        sv = padded[:, radius + i : radius + i + H, radius + j : radius + j + W]
        diff = sv - center
        w = sw * torch.exp(diff * diff * gc)
        num = num + w * sv
        den = den + w
    out = torch.round(num / den)  # half to even, as cvRound
    return out.clamp(0, 255).to(torch.uint8).reshape(frames.shape)


def thresh_to_zero(frames: torch.Tensor, thresh: int) -> torch.Tensor:
    """cv2.THRESH_TOZERO: keep values strictly above `thresh`, else 0."""
    return torch.where(frames > thresh, frames, torch.zeros_like(frames))


def _pool2d(frames: torch.Tensor, size: Tuple[int, int], op: str) -> torch.Tensor:
    """Min/max pool over the trailing two dims, stride 1, edge replication."""
    kh, kw = size
    H, W = frames.shape[-2], frames.shape[-1]
    x = frames.reshape(-1, H, W)
    iy = _edge_index(H, (kh - 1) // 2, kh // 2, x.device)
    ix = _edge_index(W, (kw - 1) // 2, kw // 2, x.device)
    p = x[:, iy][:, :, ix]
    reduce = torch.minimum if op == "min" else torch.maximum
    out = None
    for dy in range(kh):
        for dx in range(kw):
            s = p[:, dy : dy + H, dx : dx + W]
            out = s if out is None else reduce(out, s)
    return out.reshape(frames.shape)


def grayscale_opening(
    frames: torch.Tensor, size: Tuple[int, int] = (3, 3)
) -> torch.Tensor:
    """scipy.ndimage.grey_opening parity: erosion then dilation."""
    return _pool2d(_pool2d(frames, size, "min"), size, "max")


def motion_postfilter(
    motion: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """bilateral -> thresh-to-zero -> opening, the plain chain."""
    x = bilateral_blur(
        motion, cfg.bilateral_d, cfg.bilateral_sigma_color, cfg.bilateral_sigma_space
    )
    x = thresh_to_zero(x, cfg.motion_threshold)
    return grayscale_opening(x, tuple(cfg.opening_size))


def apply_postfilter(
    motion: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """The post-filter gate: CUDA frames with a 3x3 opening go to the fused
    kernel K1 when cfg.use_pallas_postfilter is set; everything else takes
    the plain chain (K1 bakes the 3x3 opening)."""
    if (
        cfg.use_pallas_postfilter
        and motion.device.type == "cuda"
        and tuple(cfg.opening_size) == (3, 3)
    ):
        from .fused_motion import fused_motion_filter

        return fused_motion_filter(motion, cfg)
    return motion_postfilter(motion, cfg)
