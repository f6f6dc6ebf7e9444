"""Synthetic surveillance video with known swift counts.

Counterpart of swiftwatcher_tpu/io/synthetic.py:make_video, producing
byte-identical frames for the same arguments (same numpy draws in the same
order): a static sky + chimney scene, swifts diving into the chimney mouth
(countable events), vanishers that end inside the ROI at a shallow angle
(rejected events) and crossers that leave the frame (no event).
make_hard_video is the counterpart of its make_hard_video, the accuracy
corpus's stress clips (crowding, occlusion, jitter, flybys, blur and
flicker) with constructed ground truth, frame for frame the same.
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


@dataclasses.dataclass
class HardVideo:
    """A stress-corpus clip with per-event ground truth.

    Unlike SyntheticVideo (whose actors get disjoint time blocks so every
    scene is perfectly countable), hard scenes allow simultaneous actors,
    occlusion, camera jitter and near-ROI flybys — the pipeline is EXPECTED
    to drop below F1=1.0 here.  entry_frames carries the constructed ground
    truth: the frame number at which each true chimney entry completes
    (the frame the swift is first absent, which is where the tracker's
    "D"-status event fires — segment_tracking.py:154-176)."""

    frames: np.ndarray
    corners: List[Tuple[int, int]]
    fps: float
    entry_frames: List[int]            # ground-truth chimney entries
    n_distractors: int                 # actors that must NOT count


def make_hard_video(
    seed: int = 0,
    n_frames: int = 84,
    H: int = 240,
    W: int = 320,
    n_entering: int = 3,
    n_flyby: int = 0,
    n_vanishing: int = 0,
    n_crossing: int = 0,
    simultaneous: bool = False,
    jitter: int = 0,
    occluder: bool = False,
    fps: float = 30.0,
    noise: int = 3,
    dot: int = 4,
    amp: int = 120,
    brightness_drift: float = 0.0,
    motion_blur: float = 0.0,
    flicker: float = 0.0,
) -> HardVideo:
    """Build a stress clip for accuracy (not parity) evaluation.

    Actor kinds:
      enter   — dives steeply into the chimney mouth (a TRUE entry);
      flyby   — skims horizontally JUST ABOVE the ROI band and exits the
                frame (never an event; a false-positive trap near the mask);
      vanish  — disappears inside the ROI at a shallow angle (a rejectable
                event: detection-only TP, det+class should reject);
      cross   — crosses the whole crop and exits (no event).

    simultaneous=True overlaps the entering swifts' flight windows in
    separated x-lanes that converge at the mouth (crowding: blobs can merge
    near the mouth and confuse any tracker — the reference's too).
    jitter=J applies integer camera shake of up to ±J px per frame (the
    whole world shifts; the chimney moves relative to the fixed crop).
    occluder=True draws a static dark wire across the approach path; swifts
    passing behind it vanish for a few frames (track fragmentation).
    motion_blur=F (0..1) smears each actor along F of its inter-frame
    displacement — a bird at 1/60 s shutter in a 30 fps capture is F~0.5;
    the sprite's total darkening is conserved (time-averaged coverage), so
    streaks are FAINTER per pixel, exactly the way real blur starves the
    RPCA sparse term.  flicker=G applies a per-frame multiplicative gain
    wander of up to ±G (auto-exposure/AGC hunting) on top of any additive
    brightness_drift.  Both default OFF with zero rng draws, so the
    corpus scenes without them keep their pixels.
    """
    rng = np.random.default_rng(seed)
    J = max(int(jitter), 0)
    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    corners = [(left, top + 6), (right, top + 6)]
    mouth_x = (left + right) // 2
    mouth_y = top

    # world canvas is padded by J on each side; the camera window into it
    # shifts per frame (actors are drawn in world coords so they shake
    # together with the scene, like real camera motion)
    HW, WW = H + 2 * J, W + 2 * J
    sky = np.zeros((HW, WW, 3), np.int32)
    sky[..., 0] = 210 + rng.integers(-10, 10)
    sky[..., 1] = 175
    sky[..., 2] = 150
    sky[J + top :, J + left : J + right] = (60, 52, 48)
    grad = (np.linspace(0, 14, HW).astype(np.int32))[:, None, None]
    base = sky + grad

    occ_y0 = occ_y1 = None
    if occluder:
        # a 3-px "power line" crossing the approach corridor ~1/3 of the
        # way up the dive; static, so RPCA's low-rank part absorbs it
        occ_y0 = J + mouth_y - int(H * 0.10)
        occ_y1 = occ_y0 + 3
        base[occ_y0:occ_y1, :] = (70, 64, 60)

    paths = []  # (t0, t1, ys, xs, kind) in WORLD coords
    entry_frames: List[int] = []
    n_distractors = 0

    def _speed_ok(length, span):
        return span <= 18 * max(length - 1, 1)

    # --- entering swifts ---
    if n_entering:
        if simultaneous:
            length = min(14, n_frames - 8)
            for k in range(n_entering):
                t0 = 3 + 2 * k                      # staggered by 2 frames
                if t0 + length + 1 >= n_frames:
                    continue
                drop = min(int(H * 0.24), 18 * (length - 1))
                lane = (k - (n_entering - 1) / 2.0) * (dot + 9)
                xs = np.linspace(mouth_x + 3 * lane, mouth_x + np.sign(lane) * 2, length)
                ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
                paths.append((t0, t0 + length, J + ys, J + xs, "enter"))
                entry_frames.append(t0 + length)
        else:
            block = max((n_frames - 6) // max(n_entering, 1), 10)
            for k in range(n_entering):
                t0 = 3 + k * block
                length = min(13, block - 3, n_frames - t0 - 2)
                if length < 4:
                    continue
                drop = min(int(H * 0.24), 18 * (length - 1))
                sx = mouth_x - 8 - 5 * (k % 3)
                xs = np.linspace(sx, mouth_x + 2 + 2 * (k % 3), length)
                ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
                paths.append((t0, t0 + length, J + ys, J + xs, "enter"))
                entry_frames.append(t0 + length)

    for k in range(n_flyby):
        length = min(12, n_frames - 8)
        t0 = 4 + k * 6 if simultaneous else min(
            n_frames - length - 3, 5 + k * (length + 4)
        )
        if t0 < 2 or length < 4:
            continue
        # skim 6-10 px ABOVE the chimney top, wall-to-wall over the mouth
        run = min(int(W * 0.30), 18 * (length - 1))
        xs = np.linspace(mouth_x - run, mouth_x + run, length)
        ys = np.full(length, float(mouth_y - 10 - 3 * (k % 2))) + np.linspace(
            0, 2.5, length
        )
        paths.append((t0, t0 + length, J + ys, J + xs, "flyby"))
        n_distractors += 1
    for k in range(n_vanishing):
        length = min(11, n_frames - 8)
        t0 = 6 + (n_flyby + k) * (length + 4)
        if t0 + length + 2 >= n_frames:
            continue
        run = min(int(W * 0.14), 18 * (length - 1))
        xs = np.linspace(mouth_x - run, mouth_x + 2 * k, length)
        ys = np.linspace(mouth_y - 9.0, mouth_y - 6.0, length)
        paths.append((t0, t0 + length, J + ys, J + xs, "vanish"))
        n_distractors += 1
    for k in range(n_crossing):
        length = min(12, n_frames - 8)
        t0 = 8 + (n_flyby + n_vanishing + k) * (length + 4)
        if t0 + length + 2 >= n_frames:
            continue
        xs = np.linspace(left - int(W * 0.16), right + int(W * 0.16), length)
        ys = np.full(length, float(mouth_y - 16 - 5 * k)) + np.linspace(0, 4, length)
        paths.append((t0, t0 + length, J + ys, J + xs, "cross"))
        n_distractors += 1

    frames = np.zeros((n_frames, H, W, 3), np.int32)
    gain = 1.0
    for t in range(n_frames):
        world = base + rng.integers(-noise, noise + 1, size=(HW, WW, 3))
        if brightness_drift:
            world = world + int(brightness_drift * t)
        for (t0, t1, ys, xs, kind) in paths:
            if t0 <= t < t1:
                y, x = int(ys[t - t0]), int(xs[t - t0])
                if motion_blur > 0.0:
                    # time-averaged coverage over the shutter interval:
                    # S sub-positions from p(t) toward p(t+1), each 1/S of
                    # the exposure; overlaps saturate at full coverage
                    i = t - t0
                    ny = ys[i + 1] if i + 1 < len(ys) else ys[i]
                    nx = xs[i + 1] if i + 1 < len(xs) else xs[i]
                    dy_b = motion_blur * (ny - ys[i])
                    dx_b = motion_blur * (nx - xs[i])
                    S = max(2, int(np.hypot(dy_b, dx_b)) + 1)
                    cover = np.zeros((HW, WW), np.float64)
                    for s in range(S):
                        sy = int(ys[i] + dy_b * s / (S - 1))
                        sx = int(xs[i] + dx_b * s / (S - 1))
                        if 0 <= sy < HW - dot and 0 <= sx < WW - dot:
                            cover[sy : sy + dot, sx : sx + dot] += 1.0 / S
                    world = world - (
                        amp * np.minimum(cover, 1.0)
                    ).astype(np.int32)[..., None]
                elif 0 <= y < HW - dot and 0 <= x < WW - dot:
                    world[y : y + dot, x : x + dot] -= amp
        if occluder:
            # occluder is FOREGROUND: re-draw it over any actor behind it
            world[occ_y0:occ_y1, :] = (
                70 + rng.integers(-noise, noise + 1),
                64,
                60,
            )
        if flicker > 0.0:
            # AGC hunting: a bounded random walk on global gain
            gain += float(rng.uniform(-1.0, 1.0)) * flicker / 3.0
            gain = float(np.clip(gain, 1.0 - flicker, 1.0 + flicker))
            world = (world.astype(np.float64) * gain).astype(np.int32)
        dy = int(rng.integers(-J, J + 1)) if J else 0
        dx = int(rng.integers(-J, J + 1)) if J else 0
        frames[t] = np.clip(world[J + dy : J + dy + H, J + dx : J + dx + W], 0, 255)

    return HardVideo(
        frames=frames.astype(np.uint8),
        corners=corners,
        fps=fps,
        entry_frames=sorted(entry_frames),
        n_distractors=n_distractors,
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
