"""The per-batch localisation program.

Counterpart of swiftwatcher_tpu/pipeline/window.py:localize_windows_gray
(and localize_windows, its entry for BGR crops):

    [stabilisation] -> IALM RPCA -> fused motion filter (K1)
    -> 8-connected CCL (K2) -> uint8 label wrap -> region tables

over a (B, T, H, W) uint8 gray batch on one device.  Stabilisation runs
only when cfg.stabilize_max_shift > 0 (an opt-in of --accuracy-pack).
localize_windows_packed / _packed6 take a wire codec packet
(io/wirecodec.py) and decode it on its device first.  localize_window is
the single-window entry for a (T, H, W, 3) BGR crop, and
localize_window_debug returns each named stage of one window (the
reference's Frame.processed_frames, for tools/torch_dump_stages.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..io.wirecodec import WirePacket, WirePacket6, decode_packet
from ..ops.ccl import label_components, wrap_labels_uint8
from ..ops.color import bgr_to_gray
from ..ops.filtering import apply_postfilter, bilateral_blur, grayscale_opening, thresh_to_zero
from ..ops.props import RegionTable, region_tables
from ..ops.rpca import rpca_motion_window, rpca_motion_window_batched
from ..ops.stabilize import stabilize_window
from ..utils.metrics import span


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
        with span("stabilize"):
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


def _packed(pkt, shape, cfg, with_bbox, stab_ref):
    B, T, H, W = shape
    if pkt.shape != (B * T, H, W):
        raise ValueError(f"a packet of {pkt.shape} frames is no (B, T, H, W) = {shape} batch")
    return localize_windows_gray(decode_packet(pkt).reshape(B, T, H, W), cfg, with_bbox,
                                 stab_ref)


def localize_windows_packed(
    pkt: WirePacket,
    shape: Tuple[int, int, int, int],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    with_bbox: bool = False,
    stab_ref: Optional[torch.Tensor] = None,
) -> Tuple[RegionTable, torch.Tensor]:
    """localize_windows_gray of an uploaded delta4 packet of a (B, T, H, W)
    batch (`shape`), decoded on its device first: the same tables as the
    raw batch's, since the decode is bit-lossless."""
    return _packed(pkt, shape, cfg, with_bbox, stab_ref)


def localize_windows_packed6(
    pkt: WirePacket6,
    shape: Tuple[int, int, int, int],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    with_bbox: bool = False,
    stab_ref: Optional[torch.Tensor] = None,
) -> Tuple[RegionTable, torch.Tensor]:
    """localize_windows_packed for a delta6 packet."""
    return _packed(pkt, shape, cfg, with_bbox, stab_ref)


def localize_window(
    crop_bgr: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> Tuple[RegionTable, torch.Tensor, torch.Tensor]:
    """(T, H, W, 3) uint8 BGR crop -> (RegionTable of (T, 256), (T, H, W)
    uint8 labels, () int32 IALM iterations).  Stabilisation (when on)
    aligns the window to its own mean, as in the JAX package."""
    gray = bgr_to_gray(crop_bgr)
    if cfg.stabilize_max_shift > 0:
        gray, _ = stabilize_window(gray, cfg.stabilize_max_shift)
    motion, iters = rpca_motion_window(gray, cfg)
    filtered = apply_postfilter(motion, cfg)
    labels, _ = label_components(filtered > 0, cfg.ccl_max_iters)
    labels_u8 = wrap_labels_uint8(labels, cfg.label_modulus)
    return region_tables(labels_u8), labels_u8, iters


def localize_window_debug(
    crop_bgr: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG, keep_stages: bool = True
) -> Tuple[RegionTable, Dict[str, torch.Tensor], torch.Tensor]:
    """localize_window with every named stage of the reference's
    Frame.processed_frames: (table, {grayscale, RPCA, bilateral, thresh_15,
    opened, cc_labeling}, iterations), each stage (T, H, W) uint8.  The
    post-filter runs stage by stage (the plain ops, not K1, whose opened
    plane is the same); a debug path, not the pipeline's.  keep_stages is
    accepted for the JAX package's signature; the stages are always
    returned."""
    gray = bgr_to_gray(crop_bgr)
    motion, iters = rpca_motion_window(gray, cfg)
    bil = bilateral_blur(motion, cfg.bilateral_d, cfg.bilateral_sigma_color,
                         cfg.bilateral_sigma_space)
    thr = thresh_to_zero(bil, cfg.motion_threshold)
    opened = grayscale_opening(thr, tuple(cfg.opening_size))
    labels, _ = label_components(opened > 0, cfg.ccl_max_iters)
    labels_u8 = wrap_labels_uint8(labels, cfg.label_modulus)
    stages = {"grayscale": gray, "RPCA": motion, "bilateral": bil, "thresh_15": thr,
              "opened": opened, "cc_labeling": labels_u8}
    return region_tables(labels_u8), stages, iters
