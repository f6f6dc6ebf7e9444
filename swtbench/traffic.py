"""Traffic: one general generator of the served clip, driven by a data file.

A traffic mix is `swtbench/traffic/<name>.json`: the scene (`video`, the
bench scene of disjoint actors, or `hard`, the stress scene with crowding,
jitter, flybys, occluders, blur and flicker), the frames of a block, the
number of blocks, the actors of a block and an optional close pass (a large
dark block crossing the crop, a bird near the camera).  Each block is drawn
from its own sub-seed `(seed, block)`, so every seed gives the same actors
at the same places and times and differs only in noise, sky tone and camera
shake.  The blocks, laid end to end, make the base clip, which the stream
loops (swtbench/source.py); a block is a whole number of 21-frame windows,
so each window of the stream repeats a window of the base clip.

The scenes follow the port's io/synthetic.py (make_video, make_hard_video),
copied here so that a later change to the program cannot change the
yardstick.  Only the chimney crop of each frame is drawn, plus the whole
first frame (the ROI mask and the stabilisation's pose are taken from it);
the crop of the first frame is taken from that whole frame.  Where a
segment filter needs whole frames, the BGR crops are kept as drawn and
`full_frames` pastes each into the first frame.  The noise is
drawn over the crop alone, so the frames are not byte-equal to the port's
generators' for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# OpenCV's 15-bit fixed-point BGR -> gray (cv2.COLOR_BGR2GRAY)
_R2Y, _G2Y, _B2Y, _SHIFT = 9798, 19235, 3735, 15

Region = List[Tuple[int, int]]  # [(x1, y1), (x2, y2)]


def gray_of_bgr(bgr: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> (...,) uint8 gray, OpenCV's shift-15 formula."""
    x = bgr.astype(np.int32)
    y = (x[..., 2] * _R2Y + x[..., 1] * _G2Y + x[..., 0] * _B2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(np.uint8)


def scene_corners(H: int, W: int) -> Region:
    """The scene's chimney top corners [(x1, y1), (x2, y2)] at H x W."""
    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    return [(left, top + 6), (right, top + 6)]


@dataclasses.dataclass
class Clip:
    """The base clip: the whole first frame and every frame's gray crop
    and, when asked for, its BGR crop."""

    first_frame: np.ndarray   # (H, W, 3) uint8 BGR
    crops: np.ndarray         # (N, h, w) uint8 gray crops of `crop`
    crop: Region
    fps: float
    bgr: Optional[np.ndarray] = None  # (N, h, w, 3) uint8 BGR crops of `crop`


def _video_paths(n_frames, H, W, n_entering=2, n_crossing=1, n_vanishing=0, dot=4):
    """make_video's actor paths: disjoint time blocks, (t0, t1, ys, xs)."""
    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    mouth_x, mouth_y = (left + right) // 2, top
    kinds = ([("enter", k) for k in range(n_entering)]
             + [("vanish", k) for k in range(n_vanishing)]
             + [("cross", k) for k in range(n_crossing)])
    paths = []
    if kinds:
        block = max((n_frames - 4) // len(kinds), 8)
        for i, (kind, k) in enumerate(kinds):
            t0 = 2 + i * block
            length = min(12, block - 3, n_frames - t0 - 2)
            if length < 3:
                continue
            if kind == "enter":
                drop = min(int(H * 0.24), 18 * (length - 1))
                xs = np.linspace(mouth_x - 8 - 5 * k, mouth_x + 2 + 2 * k, length)
                ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
            elif kind == "vanish":
                run = min(int(W * 0.14), 18 * (length - 1))
                xs = np.linspace(mouth_x - run, mouth_x + 2 * k, length)
                ys = np.linspace(mouth_y - 9.0, mouth_y - 6.0, length)
            else:
                xs = np.linspace(left - int(W * 0.16), right + int(W * 0.16), length)
                ys = np.full(length, float(mouth_y - 14 - 6 * k)) + np.linspace(0, 5, length)
            paths.append((t0, t0 + length, ys, xs))
    return paths


def _hard_paths(n_frames, H, W, J, n_entering=3, n_flyby=0, n_vanishing=0, n_crossing=0,
                simultaneous=False, dot=4):
    """make_hard_video's actor paths, in world coordinates (offset J)."""
    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    mouth_x, mouth_y = (left + right) // 2, top
    paths = []
    if n_entering and simultaneous:
        length = min(14, n_frames - 8)
        for k in range(n_entering):
            t0 = 3 + 2 * k
            if t0 + length + 1 >= n_frames:
                continue
            drop = min(int(H * 0.24), 18 * (length - 1))
            lane = (k - (n_entering - 1) / 2.0) * (dot + 9)
            xs = np.linspace(mouth_x + 3 * lane, mouth_x + np.sign(lane) * 2, length)
            ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
            paths.append((t0, t0 + length, J + ys, J + xs))
    elif n_entering:
        block = max((n_frames - 6) // max(n_entering, 1), 10)
        for k in range(n_entering):
            t0 = 3 + k * block
            length = min(13, block - 3, n_frames - t0 - 2)
            if length < 4:
                continue
            drop = min(int(H * 0.24), 18 * (length - 1))
            xs = np.linspace(mouth_x - 8 - 5 * (k % 3), mouth_x + 2 + 2 * (k % 3), length)
            ys = np.linspace(mouth_y - drop, mouth_y - dot, length)
            paths.append((t0, t0 + length, J + ys, J + xs))
    for k in range(n_flyby):
        length = min(12, n_frames - 8)
        t0 = 4 + k * 6 if simultaneous else min(n_frames - length - 3, 5 + k * (length + 4))
        if t0 < 2 or length < 4:
            continue
        run = min(int(W * 0.30), 18 * (length - 1))
        xs = np.linspace(mouth_x - run, mouth_x + run, length)
        ys = np.full(length, float(mouth_y - 10 - 3 * (k % 2))) + np.linspace(0, 2.5, length)
        paths.append((t0, t0 + length, J + ys, J + xs))
    for k in range(n_vanishing):
        length = min(11, n_frames - 8)
        t0 = 6 + (n_flyby + k) * (length + 4)
        if t0 + length + 2 >= n_frames:
            continue
        run = min(int(W * 0.14), 18 * (length - 1))
        xs = np.linspace(mouth_x - run, mouth_x + 2 * k, length)
        ys = np.linspace(mouth_y - 9.0, mouth_y - 6.0, length)
        paths.append((t0, t0 + length, J + ys, J + xs))
    for k in range(n_crossing):
        length = min(12, n_frames - 8)
        t0 = 8 + (n_flyby + n_vanishing + k) * (length + 4)
        if t0 + length + 2 >= n_frames:
            continue
        xs = np.linspace(left - int(W * 0.16), right + int(W * 0.16), length)
        ys = np.full(length, float(mouth_y - 16 - 5 * k)) + np.linspace(0, 4, length)
        paths.append((t0, t0 + length, J + ys, J + xs))
    return paths


def _subtract(world, r0, c0, y0, y1, x0, x1, value):
    """world[y0:y1, x0:x1] -= value (world coordinates; `world` holds the
    rectangle whose top-left corner is (r0, c0)), clipped to what it holds."""
    h, w = world.shape[:2]
    ya, yb = max(y0 - r0, 0), min(y1 - r0, h)
    xa, xb = max(x0 - c0, 0), min(x1 - c0, w)
    if ya < yb and xa < xb:
        world[ya:yb, xa:xb] -= value


def _block(rng, n_frames, H, W, crop, params, first_whole, keep_bgr=False):
    """One block: (its whole first frame or None, (n, h, w) gray crops,
    (n, h, w, 3) BGR crops or None).  Keeping the BGR crops draws nothing
    more."""
    scene = params.get("scene", "video")
    actors = dict(params.get("actors", {}))
    J = max(int(actors.pop("jitter", 0)), 0) if scene == "hard" else 0
    occluder = bool(actors.pop("occluder", False))
    noise = int(params.get("noise", 3))
    dot = int(params.get("dot", 4))
    amp = int(params.get("amp", 120))
    drift = float(params.get("brightness_drift", 0.0))
    blur = float(params.get("motion_blur", 0.0))
    flicker = float(params.get("flicker", 0.0))
    if scene == "video":
        paths = _video_paths(n_frames, H, W, dot=dot, **actors)
    elif scene == "hard":
        paths = _hard_paths(n_frames, H, W, J, dot=dot, **actors)
    else:
        raise ValueError(f"unknown scene {scene!r}")

    top, left, right = int(H * 0.55), int(W * 0.42), int(W * 0.60)
    HW, WW = H + 2 * J, W + 2 * J
    sky_b = 210 + int(rng.integers(-10, 10))

    def base(r0, r1, c0, c1):
        """The static world over rows r0:r1, columns c0:c1 (int32 BGR)."""
        b = np.empty((r1 - r0, c1 - c0, 3), np.int32)
        b[...] = (sky_b, 175, 150)
        ys, xs = np.arange(r0, r1)[:, None], np.arange(c0, c1)[None, :]
        stack = (ys >= J + top) & (xs >= J + left) & (xs < J + right)
        b[stack] = (60, 52, 48)
        b += np.linspace(0, 14, HW).astype(np.int32)[r0:r1, None, None]
        if occluder:
            oy0 = J + top - int(H * 0.10)
            b[max(oy0 - r0, 0):max(oy0 + 3 - r0, 0)] = (70, 64, 60)
        return b

    (x1, y1), (x2, y2) = crop
    h, w = y2 - y1, x2 - x1
    # the world rectangle that holds the crop under any camera shift
    patch = (y1, y2 + 2 * J, x1, x2 + 2 * J)
    base_patch = base(*patch)
    noise_patch = rng.integers(-noise, noise + 1, size=(n_frames, *base_patch.shape),
                               dtype=np.int16)
    whole = None
    gray = np.empty((n_frames, h, w), np.uint8)
    bgr = np.empty((n_frames, h, w, 3), np.uint8) if keep_bgr else None
    gain = 1.0
    occ_y0 = J + top - int(H * 0.10)
    for t in range(n_frames):
        whole_frame = t == 0 and first_whole
        if whole_frame:
            r0, r1, c0, c1 = 0, HW, 0, WW
            world = base(r0, r1, c0, c1) + rng.integers(-noise, noise + 1, size=(HW, WW, 3),
                                                        dtype=np.int16)
        else:
            r0, r1, c0, c1 = patch
            world = base_patch + noise_patch[t]
        if drift:
            world = world + int(drift * t)
        for t0, t1, ys, xs in paths:
            if not t0 <= t < t1:
                continue
            i = t - t0
            y, x = int(ys[i]), int(xs[i])
            if blur > 0.0:
                # time-averaged coverage over the shutter interval
                ny = ys[i + 1] if i + 1 < len(ys) else ys[i]
                nx = xs[i + 1] if i + 1 < len(xs) else xs[i]
                dy_b, dx_b = blur * (ny - ys[i]), blur * (nx - xs[i])
                S = max(2, int(np.hypot(dy_b, dx_b)) + 1)
                cover = np.zeros(world.shape[:2], np.float64)
                for s in range(S):
                    sy = int(ys[i] + dy_b * s / (S - 1))
                    sx = int(xs[i] + dx_b * s / (S - 1))
                    if 0 <= sy < HW - dot and 0 <= sx < WW - dot:
                        _subtract(cover, r0, c0, sy, sy + dot, sx, sx + dot, -1.0 / S)
                world = world - (amp * np.minimum(cover, 1.0)).astype(np.int32)[..., None]
            elif 0 <= y < HW - dot and 0 <= x < WW - dot:
                _subtract(world, r0, c0, y, y + dot, x, x + dot, amp)
        if occluder:
            tone = 70 + int(rng.integers(-noise, noise + 1))
            ya, yb = max(occ_y0 - r0, 0), max(occ_y0 + 3 - r0, 0)
            world[ya:yb] = (tone, 64, 60)
        if flicker > 0.0:
            gain += float(rng.uniform(-1.0, 1.0)) * flicker / 3.0
            gain = float(np.clip(gain, 1.0 - flicker, 1.0 + flicker))
            world = (world.astype(np.float64) * gain).astype(np.int32)
        dy = int(rng.integers(-J, J + 1)) if J else 0
        dx = int(rng.integers(-J, J + 1)) if J else 0
        if whole_frame:
            frame = np.clip(world[J + dy:J + dy + H, J + dx:J + dx + W], 0, 255).astype(np.uint8)
            whole = frame
            cam = frame[y1:y2, x1:x2].astype(np.int32)
        else:
            cam = np.clip(world[J + dy:J + dy + h, J + dx:J + dx + w], 0, 255)
        cam = _close_pass(cam, t, crop, params.get("close_pass"))
        gray[t] = gray_of_bgr(cam)
        if bgr is not None:
            bgr[t] = cam
    return whole, gray, bgr


def _close_pass(cam: np.ndarray, t: int, crop: Region, cp) -> np.ndarray:
    """A dark `size` x `size` block crossing the frame in frames
    [t0, t1) of a block, `step` px a frame from column x0, at rows
    [row, row + size) of the whole frame; `cam` is the frame's crop."""
    if not cp or not cp["t0"] <= t < cp["t1"]:
        return cam
    (x1, y1), _ = crop
    size, amp = int(cp["size"]), int(cp.get("amp", 120))
    x = int(cp["x0"]) + int(cp["step"]) * (t - int(cp["t0"]))
    out = cam.astype(np.int32)
    _subtract(out, y1, x1, int(cp["row"]), int(cp["row"]) + size, x, x + size, amp)
    return np.clip(out, 0, 255)


def generate(params: dict, seed: int, H: int, W: int, crop: Region,
             keep_bgr: bool = False) -> Clip:
    """The base clip of the traffic `params` for `seed` at H x W, with the
    gray crops of region `crop` and, with `keep_bgr`, their BGR crops (the
    same draws: the gray crops do not change)."""
    n = int(params["block_frames"])
    blocks = int(params["blocks"])
    key = int(seed) & (2**64 - 1)
    first, crops, bgrs = None, [], []
    for b in range(blocks):
        rng = np.random.default_rng([key, b])
        whole, gray, bgr = _block(rng, n, H, W, crop, params, b == 0, keep_bgr)
        if b == 0:
            first = whole
        crops.append(gray)
        bgrs.append(bgr)
    return Clip(first_frame=first, crops=np.concatenate(crops), crop=crop,
                fps=float(params.get("fps", 30.0)),
                bgr=np.concatenate(bgrs) if keep_bgr else None)


def full_frames(clip: Clip) -> np.ndarray:
    """(N, H, W, 3) uint8: each frame of the base clip whole, its BGR crop
    pasted into the first frame at the crop region.  Outside the crop every
    frame shows the first frame's world, which is all that reaches past the
    crop: a classifier's box expanded at a segment near the crop's edge."""
    (x1, y1), (x2, y2) = clip.crop
    out = np.empty((len(clip.bgr), *clip.first_frame.shape), np.uint8)
    for f, bgr in zip(out, clip.bgr):
        f[...] = clip.first_frame
        f[y1:y2, x1:x2] = bgr
    return out
