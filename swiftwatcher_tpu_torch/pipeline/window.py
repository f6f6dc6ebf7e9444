"""The per-batch localisation program.

Counterpart of swiftwatcher_tpu/pipeline/window.py:localize_windows_gray
(and localize_windows, its entry for BGR crops):

    [stabilisation] -> IALM RPCA -> fused motion filter (K1)
    -> 8-connected CCL (K2) -> uint8 label wrap -> region tables

over a (B, T, H, W) uint8 gray batch on one device.  Stabilisation runs
only when cfg.stabilize_max_shift > 0 (an opt-in of --accuracy-pack).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..ops.ccl import label_components, wrap_labels_uint8
from ..ops.color import bgr_to_gray
from ..ops.filtering import apply_postfilter
from ..ops.props import RegionTable, region_tables
from ..ops.rpca import rpca_motion_window_batched
from ..ops.stabilize import stabilize_window


def localize_windows_gray(
    gray: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    with_bbox: bool = False,
    stab_ref: Optional[torch.Tensor] = None,
) -> Tuple[RegionTable, torch.Tensor]:
    """(B, T, H, W) uint8 gray -> (RegionTable of (B, T, 256), (B,) iters).

    with_bbox: also fill the tables' bbox fields, which the classifier's
    crops and the segment export need; tracking and events read centroids
    only, so they stay zero otherwise.
    stab_ref: the (H, W) pose that stabilisation aligns every frame to
    (the runner's: the gray crop of the ROI mask's frame); None aligns
    each window to its own mean."""
    if cfg.stabilize_max_shift > 0:
        gray, _ = stabilize_window(gray, cfg.stabilize_max_shift, stab_ref)
    B, T, H, W = gray.shape
    motion, iters = rpca_motion_window_batched(gray, cfg)
    filtered = apply_postfilter(motion.reshape(B * T, H, W), cfg)
    labels, _ = label_components(filtered > 0, cfg.ccl_max_iters)
    labels_u8 = wrap_labels_uint8(labels, cfg.label_modulus)
    table = region_tables(labels_u8, with_bbox=with_bbox)
    return table.map(lambda a: a.reshape(B, T, *a.shape[1:])), iters


def localize_windows(
    crops: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG, with_bbox: bool = False
) -> Tuple[RegionTable, torch.Tensor]:
    """(B, T, H, W, 3) uint8 BGR crops -> localize_windows_gray of their gray."""
    return localize_windows_gray(bgr_to_gray(crops), cfg, with_bbox=with_bbox)
