"""BGR -> grayscale with OpenCV's 15-bit fixed-point formula, bit-exact.

Counterpart of swiftwatcher_tpu/ops/color.py (no cv2 here):

    Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
"""

from __future__ import annotations

import numpy as np
import torch

_R2Y = 9798
_G2Y = 19235
_B2Y = 3735
_SHIFT = 15


def bgr_to_gray_host(frames) -> np.ndarray:
    """(..., 3) uint8 BGR numpy -> (...,) uint8 gray, on the host."""
    x = np.asarray(frames).astype(np.int32)
    y = (
        x[..., 2] * _R2Y + x[..., 1] * _G2Y + x[..., 0] * _B2Y
        + (1 << (_SHIFT - 1))
    ) >> _SHIFT
    return y.astype(np.uint8)


def bgr_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR tensor -> (...,) uint8 gray on the same device."""
    x = frames.to(torch.int32)
    y = (
        x[..., 2] * _R2Y + x[..., 1] * _G2Y + x[..., 0] * _B2Y
        + (1 << (_SHIFT - 1))
    ) >> _SHIFT
    return y.to(torch.uint8)
