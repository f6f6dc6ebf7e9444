"""K1: the fused motion post-filter (bilateral -> threshold -> 3x3 opening).

Counterpart of swiftwatcher_tpu/ops/pallas/fused_motion.py.  On a CUDA
tensor `fused_motion_filter` launches the hand-written kernel
csrc/fused_motion.cu; on a CPU tensor it runs the plain PyTorch chain
(`fused_motion_filter_reference`), which the kernel is held against.

The kernel works on blocks of `BLOCK` output pixels (rows, columns), each
staged with a halo of radius + 2 rows and `MARGIN` columns; it skips a
block whose staged input is all at or below the threshold, and inside the
others the pixels whose (2r+1)^2 input window is (both write zeros).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..config import DEFAULT_CONFIG, PipelineConfig
from .filtering import bilateral_constants, motion_postfilter

BLOCK = (24, 128)   # output rows, columns of one block of the kernel
MARGIN = 16         # staged columns on each side of a block
MAX_RADIUS = 8      # bilateral_d // 2 the kernel takes


def fused_motion_filter_reference(
    motion: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Plain PyTorch version of K1: the unfused chain with a 3x3 opening."""
    if tuple(cfg.opening_size) != (3, 3):
        raise ValueError("K1 bakes a 3x3 opening; use motion_postfilter")
    return motion_postfilter(motion, cfg)


def fused_motion_filter(
    motion: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """(N, H, W) uint8 motion -> filtered uint8, one kernel pass on CUDA."""
    if motion.device.type == "cpu":
        return fused_motion_filter_reference(motion, cfg)
    if tuple(cfg.opening_size) != (3, 3):
        raise ValueError("K1 bakes a 3x3 opening; use motion_postfilter")
    build.check_operand("fused_motion_filter", motion, torch.uint8)
    N, H, W = motion.shape
    radius, space, gc = bilateral_constants(
        cfg.bilateral_d, cfg.bilateral_sigma_color, cfg.bilateral_sigma_space
    )
    if radius > MAX_RADIUS:
        raise ValueError(f"fused_motion_filter: bilateral radius {radius} > {MAX_RADIUS}")
    if not 0 <= cfg.motion_threshold <= 255:
        raise ValueError(f"fused_motion_filter: threshold {cfg.motion_threshold} outside 0..255")
    if H <= radius or W <= radius:
        raise ValueError(f"fused_motion_filter: frame {H}x{W} below the reflect pad")
    out = torch.empty_like(motion)
    if N == 0:
        return out
    weights = (ctypes.c_float * len(space))(*space)
    build.launch(
        "fused_motion", "swt_fused_motion", motion.device,
        motion.data_ptr(), out.data_ptr(), N, H, W, radius,
        weights, len(space), gc, float(cfg.motion_threshold),
    )
    fused_motion_filter.launches += 1
    return out


fused_motion_filter.launches = 0
