"""Synthetic surveillance video with known swift counts.

Counterpart of swiftwatcher_tpu/io/synthetic.py:make_video, producing
byte-identical frames for the same arguments (same numpy draws in the same
order): a static sky + chimney scene, swifts diving into the chimney mouth
(countable events), vanishers that end inside the ROI at a shallow angle
(rejected events) and crossers that leave the frame (no event).
write_container puts such frames into a video container, as test input
for the decode backends.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticVideo:
    frames: np.ndarray                 # (N, H, W, 3) uint8 BGR
    corners: List[Tuple[int, int]]     # chimney top corners [(x1,y1),(x2,y2)]
    fps: float
    n_entering: int                    # swifts that dive into the chimney
    n_crossing: int                    # distractors that leave the frame
    n_vanishing: int                   # distractors that vanish inside the ROI


def make_video(
    seed: int = 0,
    n_frames: int = 63,
    H: int = 240,
    W: int = 320,
    n_entering: int = 2,
    n_crossing: int = 1,
    n_vanishing: int = 0,
    fps: float = 30.0,
    noise: int = 3,
    dot: int = 4,
    amp: int = 120,
    brightness_drift: float = 0.0,
) -> SyntheticVideo:
    """Build a synthetic clip.  Actors get disjoint time blocks so blobs
    never merge; the counts returned are the actors that fit the clip."""
    rng = np.random.default_rng(seed)
    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    corners = [(left, top + 6), (right, top + 6)]
    mouth_x = (left + right) // 2
    mouth_y = top

    sky = np.zeros((H, W, 3), np.int32)
    sky[..., 0] = 210 + rng.integers(-10, 10)   # B
    sky[..., 1] = 175
    sky[..., 2] = 150
    sky[top:, left:right] = (60, 52, 48)        # dark chimney stack
    grad = (np.linspace(0, 14, H).astype(np.int32))[:, None, None]
    base = sky + grad

    frames = np.zeros((n_frames, H, W, 3), np.uint8)
    kinds = (
        [("enter", k) for k in range(n_entering)]
        + [("vanish", k) for k in range(n_vanishing)]
        + [("cross", k) for k in range(n_crossing)]
    )
    paths = []  # (t0, t1, ys, xs)
    realized = {"enter": 0, "vanish": 0, "cross": 0}
    if kinds:
        block = max((n_frames - 4) // len(kinds), 8)
        for i, (kind, k) in enumerate(kinds):
            t0 = 2 + i * block
            length = min(12, block - 3, n_frames - t0 - 2)
            if length < 3:
                continue
            realized[kind] += 1
            if kind == "enter":
                drop = min(int(H * 0.24), 18 * (length - 1))
                sx = mouth_x - 8 - 5 * k
                xs = np.linspace(sx, mouth_x + 2 + 2 * k, length)
                ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
            elif kind == "vanish":
                run = min(int(W * 0.14), 18 * (length - 1))
                xs = np.linspace(mouth_x - run, mouth_x + 2 * k, length)
                ys = np.linspace(mouth_y - 9.0, mouth_y - 6.0, length)
            else:
                xs = np.linspace(left - int(W * 0.16), right + int(W * 0.16), length)
                ys = np.full(length, float(mouth_y - 14 - 6 * k)) + np.linspace(
                    0, 5, length
                )
            paths.append((t0, t0 + length, ys, xs))

    for t in range(n_frames):
        f = base + rng.integers(-noise, noise + 1, size=(H, W, 3))
        if brightness_drift:
            f = f + int(brightness_drift * t)
        for (t0, t1, ys, xs) in paths:
            if t0 <= t < t1:
                y, x = int(ys[t - t0]), int(xs[t - t0])
                if 0 <= y < H - dot and 0 <= x < W - dot:
                    f[y : y + dot, x : x + dot] -= amp
        frames[t] = np.clip(f, 0, 255)

    return SyntheticVideo(
        frames=frames,
        corners=corners,
        fps=fps,
        n_entering=realized["enter"],
        n_crossing=realized["cross"],
        n_vanishing=realized["vanish"],
    )


def write_container(path, frames, fps: float, fourcc: str) -> bool:
    """Write (H, W, 3) uint8 BGR frames (any iterable; the first sets the
    size) into a container through cv2.VideoWriter with codec `fourcc`
    ("MJPG" for an AVI, "mp4v" for an MP4); False where cv2 cannot open
    that codec."""
    import cv2

    writer = None
    try:
        for f in frames:
            if writer is None:
                writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                                         (f.shape[1], f.shape[0]))
                if not writer.isOpened():
                    return False
            writer.write(f)
    finally:
        if writer is not None:
            writer.release()
    return writer is not None
