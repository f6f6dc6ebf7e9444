"""Geometry, ROI mask, stabilisation and per-frame segments, plainly.

  crop / ROI regions     image_filtering.py:31-91
  ROI mask               image_filtering.py:99-122 (OpenCV, as there)
  stabilisation          integer-shift SAD search against the pose of the
                         first frame's crop (the --accuracy-pack extension)
  IALM -> motion         image_filtering.py:220-253: clip(-E, 0, 255) -> uint8
  post-filter            data_structures.py:194-202: cv2.bilateralFilter,
                         THRESH_TOZERO, grey opening
  components             image_filtering.py:329: cv2.connectedComponents,
                         labels cast to uint8
  centroids, boxes       regionprops order: ascending label value
"""

from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np
import torch
from scipy import ndimage

from .ialm import ialm


def regions(corners, p: dict):
    """(crop region, ROI region) from the two chimney corners."""
    left = min(corners[0][0], corners[1][0])
    right = max(corners[0][0], corners[1][0])
    bottom = max(corners[0][1], corners[1][1])
    w = right - left
    crop = [(left - int(p["crop_side_ratio"] * w), bottom - int(p["crop_up_ratio"] * w)),
            (right + int(p["crop_side_ratio"] * w), bottom + int(p["crop_down_ratio"] * w))]
    roi = [(int(left + p["roi_inset_ratio"] * w), int(bottom - p["roi_height_ratio"] * w)),
           (int(right - p["roi_inset_ratio"] * w), int(bottom))]
    return crop, roi


def roi_mask(frame: np.ndarray, corners, p: dict) -> np.ndarray:
    """The crop-sized uint8 mask, 255 inside the chimney's ROI."""
    crop, roi = regions(corners, p)
    k = int(p["roi_median_ksize"])
    strip = frame[roi[0][1]:roi[1][1], roi[0][0]:roi[1][0]]
    blurred = cv2.medianBlur(cv2.medianBlur(strip, k), k)
    _, th = cv2.threshold(cv2.split(blurred)[0], 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    edge = cv2.Canny(th, 0, 256)
    dil = cv2.dilate(edge, kernel=np.ones((int(p["roi_dilate_n"]), 1), np.uint8), anchor=(0, 0))
    canvas = np.zeros(frame.shape[:2], np.uint8)
    canvas[roi[0][1]:roi[1][1], roi[0][0]:roi[1][0]] = dil
    cropped = canvas[crop[0][1]:crop[1][1], crop[0][0]:crop[1][0]]
    _, mask = cv2.threshold(cropped, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    return mask


def stabilize(gray: torch.Tensor, J: int, ref: torch.Tensor):
    """Align (..., H, W) uint8 frames to the (H, W) pose `ref`: each frame
    becomes the shift (dy, dx) in [-J, J]^2 of its edge-replicated copy
    with the least sum of absolute differences to `ref`; a tie goes to the
    first shift in row-major order.  (aligned uint8, shifts (..., 2))."""
    H, W = gray.shape[-2:]
    rows = torch.arange(-J, H + J, device=gray.device).clamp(0, H - 1)
    cols = torch.arange(-J, W + J, device=gray.device).clamp(0, W - 1)
    padded = gray[..., rows, :][..., cols].to(torch.int32)
    ref = ref.to(device=gray.device, dtype=torch.int32)
    shifts = [(dy, dx) for dy in range(-J, J + 1) for dx in range(-J, J + 1)]
    best = best_sad = None
    out = gray.clone()
    for i, (dy, dx) in enumerate(shifts):
        cand = padded[..., J + dy:J + dy + H, J + dx:J + dx + W]
        sad = (cand - ref).abs().sum(dim=(-2, -1))
        if best is None:
            best, best_sad = torch.zeros_like(sad), sad
            out = cand.to(torch.uint8)
            continue
        better = sad < best_sad
        best = torch.where(better, i, best)
        best_sad = torch.where(better, sad, best_sad)
        out = torch.where(better[..., None, None], cand.to(torch.uint8), out)
    table = torch.tensor(shifts, dtype=torch.int32, device=gray.device)
    return out, table[best]


def motion(windows: torch.Tensor, p: dict, precision: str = "float64", chunk: int = 16):
    """(U, T, H, W) uint8 windows -> ((U, T, H, W) uint8 motion on the
    host, (U,) IALM iterations), `chunk` windows at a time."""
    U, T, H, W = windows.shape
    out = np.empty((U, T, H, W), np.uint8)
    iters = np.empty(U, np.int64)
    for s in range(0, U, chunk):
        X = windows[s:s + chunk].reshape(-1, T, H * W)
        E, it = ialm(X, p["rpca_lambda"], p["rpca_tol"], p["rpca_max_iter"], p["rpca_rho"],
                     p["rpca_mu_cap"], precision)
        out[s:s + chunk] = torch.clamp(-E, 0, 255).to(torch.uint8).reshape(-1, T, H, W).cpu().numpy()
        iters[s:s + chunk] = it.cpu().numpy()
        del X, E
    return out, iters


def segments(frame_motion: np.ndarray, p: dict, boxes: bool = False):
    """One frame's segment centroids (row, col), ascending by label; with
    `boxes`, (centroids, bounding boxes [y1, x1, y2, x2], bottom and right
    exclusive, as regionprops gives them)."""
    f = cv2.bilateralFilter(frame_motion, int(p["bilateral_d"]), float(p["bilateral_sigma_color"]),
                            float(p["bilateral_sigma_space"]))
    _, f = cv2.threshold(f, int(p["motion_threshold"]), 255, cv2.THRESH_TOZERO)
    f = ndimage.grey_opening(f, size=tuple(p["opening_size"]))
    if not f.any():
        return ([], []) if boxes else []
    _, lbl = cv2.connectedComponents(f)
    lbl = (lbl % int(p["label_modulus"])).astype(np.int64).ravel()
    area = np.bincount(lbl, minlength=256)
    ys, xs = np.divmod(np.arange(lbl.size), f.shape[1])
    sum_y = np.bincount(lbl, weights=ys, minlength=256)
    sum_x = np.bincount(lbl, weights=xs, minlength=256)
    ks = np.flatnonzero(area[1:]) + 1
    centroids = [(sum_y[k] / area[k], sum_x[k] / area[k]) for k in ks]
    if not boxes:
        return centroids
    fg = np.flatnonzero(lbl)
    y0, x0 = np.full(256, lbl.size), np.full(256, lbl.size)
    y1, x1 = np.full(256, -1), np.full(256, -1)
    np.minimum.at(y0, lbl[fg], ys[fg])
    np.minimum.at(x0, lbl[fg], xs[fg])
    np.maximum.at(y1, lbl[fg], ys[fg])
    np.maximum.at(x1, lbl[fg], xs[fg])
    return centroids, [[int(y0[k]), int(x0[k]), int(y1[k]) + 1, int(x1[k]) + 1] for k in ks]
