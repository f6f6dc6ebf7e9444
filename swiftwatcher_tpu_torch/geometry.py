"""Crop and ROI geometry, shared with the JAX package.

swiftwatcher_tpu/geometry.py is plain Python with neither JAX nor pandas;
the port's modules and scripts import it from here.
"""

from swiftwatcher_tpu.geometry import (
    Region,
    crop_region_from_corners,
    roi_crop_region_from_corners,
)

__all__ = ["Region", "crop_region_from_corners", "roi_crop_region_from_corners"]
