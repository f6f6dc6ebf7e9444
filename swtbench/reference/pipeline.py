"""The reference over a served stream.

The stream's frame n is frame n mod N of the base clip, and N is a whole
number of windows, so window k of the stream is window k mod (N / T) of
the clip: the reference localises the clip's windows once and tracks the
whole stream's frames over their segments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..traffic import gray_of_bgr
from .localize import motion, regions, roi_mask, segments, stabilize
from .track import Tracker, labels


def run_reference(first_frame: np.ndarray, crops: np.ndarray, corners, p: dict,
                  n_frames: int, device, precision: str = "float64") -> dict:
    """The reference's results for the first `n_frames` frames of the
    stream that loops `crops` (N, h, w), N a multiple of the window:
    events [(first centroid, last centroid, frame number)], the predicted
    and rejected totals, and for each of the clip's windows its IALM
    iterations, for each of its frames the segment centroids (row, col) in
    ascending label order and, under stabilisation, the (dy, dx) shift
    ((N, 2) int32; None without stabilisation)."""
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
    segs = [[segments(moving[u, t], p) for t in range(T)] for u in range(U)]
    tracker = Tracker(roi_mask(first_frame, corners, p), p)
    for fn in range(n_frames):
        tracker.step(segs[(fn // T) % U][fn % T], fn)
    predicted, rejected = labels(tracker.events, p)
    return {"events": tracker.events, "predicted": predicted, "rejected": rejected,
            "iters": iters, "segments": [s for window in segs for s in window],
            "shifts": shifts}
