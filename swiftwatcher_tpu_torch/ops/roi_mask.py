"""Chimney ROI-mask construction (once per video), bit-exact.

Counterpart of swiftwatcher_tpu/ops/roi_mask.py, the reference's
generate_roi_mask chain:

    crop(ROI strip) -> medianBlur(9) x2 -> B channel -> Otsu binary
    -> Canny(0, 256) -> 20x1 upward dilation -> paste into a full-frame
    canvas -> crop(crop_region) -> Otsu

with OpenCV's integer semantics for each op (see the JAX module).  Runs on
the caller's device; the Otsu threshold is a float64 scan on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..geometry import Region


def _edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate-pad the first two dims by r."""
    H, W = img.shape[0], img.shape[1]
    iy = torch.arange(-r, H + r, device=img.device).clamp(0, H - 1)
    ix = torch.arange(-r, W + r, device=img.device).clamp(0, W - 1)
    return img[iy][:, ix]


def median_blur(img: torch.Tensor, ksize: int = 9) -> torch.Tensor:
    """cv2.medianBlur parity: per-channel k x k median, edge-replicated.
    img: (H, W) or (H, W, C) uint8."""
    r = ksize // 2
    H, W = img.shape[0], img.shape[1]
    p = _edge_pad(img, r)
    stack = torch.stack(
        [p[i : i + H, j : j + W] for i in range(ksize) for j in range(ksize)]
    )
    return torch.sort(stack, dim=0).values[(ksize * ksize) // 2]


def otsu_threshold_value(img) -> int:
    """Otsu threshold of a uint8 image: cv2's float64 scan, first maximum."""
    img = np.asarray(img)
    hist = np.bincount(img.astype(np.int32).ravel(), minlength=256).astype(np.float64)
    i = np.arange(256, dtype=np.float64)
    p = hist * (1.0 / img.size)
    q1 = np.cumsum(p)
    cum_ip = np.cumsum(i * p)
    q2 = 1.0 - q1
    eps = np.float32(1.1920929e-07)  # FLT_EPSILON, as cv2 uses
    valid = (np.minimum(q1, q2) >= eps) & (np.maximum(q1, q2) <= 1.0 - eps)
    mu1 = cum_ip / np.where(q1 > 0, q1, 1.0)
    mu2 = (cum_ip[-1] - q1 * mu1) / np.where(q2 > 0, q2, 1.0)
    sigma = np.where(valid, q1 * q2 * (mu1 - mu2) ** 2, -1.0)
    return int(np.argmax(sigma))


def otsu_binary(img: torch.Tensor) -> torch.Tensor:
    """THRESH_BINARY + THRESH_OTSU: 255 where strictly above the threshold."""
    t = otsu_threshold_value(img.cpu().numpy())
    return torch.where(img.to(torch.int32) > t, 255, 0).to(torch.uint8)


def _sobel3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy with BORDER_REPLICATE."""
    p = _edge_pad(x, 1)
    H, W = x.shape

    def sl(dy, dx):
        return p[dy : dy + H, dx : dx + W]

    dx = -sl(0, 0) + sl(0, 2) - 2 * sl(1, 0) + 2 * sl(1, 2) - sl(2, 0) + sl(2, 2)
    dy = -sl(0, 0) - 2 * sl(0, 1) - sl(0, 2) + sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)
    return dx, dy


def canny(img: torch.Tensor, low: int = 0, high: int = 256) -> torch.Tensor:
    """cv2.Canny(img, low, high) parity: L1 gradient, aperture 3, fixed-point
    TG22 direction quantisation, zero-magnitude virtual borders, 8-connected
    hysteresis from strong (> high) pixels through candidates (> low)."""
    x = img.to(torch.int32)
    dx, dy = _sobel3(x)
    mag = dx.abs() + dy.abs()
    H, W = mag.shape
    magp = torch.nn.functional.pad(mag, (1, 1, 1, 1))

    def nb(dyo, dxo):
        return magp[1 + dyo : 1 + dyo + H, 1 + dxo : 1 + dxo + W]

    shift = 15
    tg22 = int(0.4142135623730950488016887242097 * (1 << shift) + 0.5)
    ax = dx.abs()
    ay = dy.abs() << shift
    tg22x = ax * tg22
    tg67x = tg22x + (ax << (shift + 1))
    positive = (dx ^ dy) >= 0

    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    keep_d = torch.where(
        positive,
        (mag > nb(-1, -1)) & (mag > nb(1, 1)),
        (mag > nb(-1, 1)) & (mag > nb(1, -1)),
    )
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))
    candidate = (mag > low) & keep
    edges = candidate & (mag > high)
    while True:
        grown = torch.nn.functional.max_pool2d(
            edges[None, None].to(torch.float32), 3, stride=1, padding=1
        )[0, 0] > 0
        new = (candidate & grown) | edges
        if torch.equal(new, edges):
            break
        edges = new
    return torch.where(edges, 255, 0).to(torch.uint8)


def dilate_upwards(img: torch.Tensor, n: int = 20) -> torch.Tensor:
    """cv2.dilate with an (n x 1) kernel anchored at (0, 0): the max of the
    n pixels at and below each pixel."""
    H = img.shape[0]
    p = torch.nn.functional.pad(img, (0, 0, 0, n - 1))
    out = p[0:H]
    for k in range(1, n):
        out = torch.maximum(out, p[k : k + H])
    return out


def generate_roi_mask(
    frame_bgr,
    roi_region: Region,
    crop_region: Region,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    *,
    device: torch.device,
) -> torch.Tensor:
    """(H, W, 3) uint8 full frame -> crop-region-sized uint8 mask (255 =
    inside the chimney ROI), on `device`."""
    frame = torch.as_tensor(np.asarray(frame_bgr), device=device)
    (rx1, ry1), (rx2, ry2) = roi_region
    strip = frame[ry1:ry2, rx1:rx2]
    blurred = median_blur(median_blur(strip, cfg.roi_median_ksize), cfg.roi_median_ksize)
    thresh = otsu_binary(blurred[..., 0])
    dilated = dilate_upwards(canny(thresh, 0, 256), cfg.roi_dilate_n)

    H, W = frame.shape[0], frame.shape[1]
    canvas = torch.zeros((H, W), dtype=torch.uint8, device=device)
    h, w = dilated.shape
    # dynamic_update_slice semantics: the start clamps so the patch fits
    y0 = min(max(ry1, 0), H - h)
    x0 = min(max(rx1, 0), W - w)
    canvas[y0 : y0 + h, x0 : x0 + w] = dilated
    (cx1, cy1), (cx2, cy2) = crop_region
    return otsu_binary(canvas[cy1:cy2, cx1:cx2])
