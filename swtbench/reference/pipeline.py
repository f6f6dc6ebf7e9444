"""The reference over a served stream.

The stream's frame n is frame n mod N of the base clip, and N is a whole
number of windows, so window k of the stream is window k mod (N / T) of
the clip: the reference localises the clip's windows once and tracks the
whole stream's frames over their segments.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..traffic import gray_of_bgr
from . import classify
from .localize import motion, regions, roi_mask, segments, stabilize
from .track import Tracker, labels


def run_reference(first_frame: np.ndarray, crops: np.ndarray, corners, p: dict,
                  n_frames: int, device, precision: str = "float64",
                  frames: Optional[np.ndarray] = None, weights: Optional[Path] = None) -> dict:
    """The reference's results for the first `n_frames` frames of the
    stream that loops `crops` (N, h, w), N a multiple of the window:
    events [(first centroid, last centroid, frame number)], the predicted
    and rejected totals, and for each of the clip's windows its IALM
    iterations, for each of its frames the segment centroids (row, col) in
    ascending label order and, under stabilisation, the (dy, dx) shift
    ((N, 2) int32; None without stabilisation).

    With `weights` (a segment filter's .npz) and the clip's whole BGR
    `frames` (N, H, W, 3), every segment is classified (classify.py, in
    `precision`) and the rejected ones are dropped before the tracker;
    "logits" then holds, for each frame of the clip, each segment's (2,)
    float64 logits in label order (None for an empty slice), and "boxes"
    their bounding boxes."""
    T = int(p["window_size"])
    N, h, w = crops.shape
    if N % T:
        raise ValueError(f"a clip of {N} frames is no whole number of {T}-frame windows")
    crop, _ = regions(corners, p)
    (x1, y1), (x2, y2) = crop
    if (y2 - y1, x2 - x1) != (h, w):
        raise ValueError(f"crops of {h} x {w} are not the crop region {crop}")
    U = N // T
    windows = torch.from_numpy(crops.reshape(U, T, h, w)).to(device)
    J = int(p["stabilize_max_shift"])
    shifts = None
    if J > 0:
        pose = torch.from_numpy(gray_of_bgr(first_frame[y1:y2, x1:x2])).to(device)
        windows, shifts = stabilize(windows, J, pose)
        shifts = shifts.reshape(N, 2).cpu().numpy()
    moving, iters = motion(windows, p, precision)
    del windows
    found = [segments(moving[fn // T, fn % T], p, boxes=weights is not None) for fn in range(N)]
    del moving
    seg_logits = boxes = None
    kept = found
    if weights is not None:
        boxes = [b for _, b in found]
        seg_logits, kept = classify_segments(frames, boxes, (x1, y1), p, device, weights,
                                             precision)
        found = [c for c, _ in found]
        kept = [[c for c, keep in zip(cs, ks) if keep] for cs, ks in zip(found, kept)]
    tracker = Tracker(roi_mask(first_frame, corners, p), p)
    for fn in range(n_frames):
        tracker.step(kept[fn % N], fn)
    predicted, rejected = labels(tracker.events, p)
    return {"events": tracker.events, "predicted": predicted, "rejected": rejected,
            "iters": iters, "segments": found, "shifts": shifts, "logits": seg_logits,
            "boxes": boxes}


def classify_segments(frames, boxes, origin, p, device, weights, precision="float64"):
    """(each frame's segments' logits, each frame's keep flags) of the
    segments in `boxes` (per frame, crop coordinates) of the whole
    `frames`, the crop region's top-left corner at `origin` (x, y)."""
    w = classify.load_weights(weights, device)
    inputs, where = [], []
    for fn, frame_boxes in enumerate(boxes):
        for k, box in enumerate(frame_boxes):
            x = classify.network_input(frames[fn], box, origin, p)
            if x is not None:
                inputs.append(x)
                where.append((fn, k))
    out = classify.logits(w, inputs, precision)
    seg_logits = [[None] * len(b) for b in boxes]
    for (fn, k), lg in zip(where, out):
        seg_logits[fn][k] = lg
    keep = [[lg is not None and int(np.argmax(lg)) == 1 for lg in fl] for fl in seg_logits]
    return seg_logits, keep
