"""Chimney geometry: crop region and ROI strip derivation.

The port's copy of swiftwatcher_tpu/geometry.py.  Pure-Python host-side
helpers (run once per video).  Semantics match the reference (image_filtering.py:31-91): the crop region is the chimney bounding
box expanded to a 1.25w x 0.625w rectangle; the ROI strip is the top 0.25w of
the chimney inset by 0.025w per side.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .config import PipelineConfig, DEFAULT_CONFIG

Point = Tuple[int, int]
Region = List[Point]  # [(x1, y1), (x2, y2)]


def chimney_extents(corners: Sequence[Point]) -> Tuple[int, int, int]:
    """Outermost (left, right, bottom) of the two user-picked corners.

    Mirrors image_filtering.py:78-91.
    """
    left = min(corners[0][0], corners[1][0])
    right = max(corners[0][0], corners[1][0])
    bottom = max(corners[0][1], corners[1][1])
    return left, right, bottom


def crop_region_from_corners(
    corners: Sequence[Point], cfg: PipelineConfig = DEFAULT_CONFIG
) -> Region:
    """Crop rectangle around the chimney top (image_filtering.py:31-53)."""
    left, right, bottom = chimney_extents(corners)
    width = right - left
    return [
        (left - int(cfg.crop_side_ratio * width), bottom - int(cfg.crop_up_ratio * width)),
        (right + int(cfg.crop_side_ratio * width), bottom + int(cfg.crop_down_ratio * width)),
    ]


def roi_crop_region_from_corners(
    corners: Sequence[Point], cfg: PipelineConfig = DEFAULT_CONFIG
) -> Region:
    """ROI strip across the chimney mouth (image_filtering.py:56-75)."""
    left, right, bottom = chimney_extents(corners)
    width = right - left
    return [
        (int(left + cfg.roi_inset_ratio * width), int(bottom - cfg.roi_height_ratio * width)),
        (int(right - cfg.roi_inset_ratio * width), int(bottom)),
    ]


def crop_array(frame, region: Region):
    """Slice a (H, W[, C]) array to a region (image_filtering.py:199-203)."""
    return frame[region[0][1] : region[1][1], region[0][0] : region[1][0]]


def region_shape(region: Region) -> Tuple[int, int]:
    """(height, width) of a region."""
    return region[1][1] - region[0][1], region[1][0] - region[0][0]
