"""The served stream: the base clip looped, as a live feed.

`StreamSource` serves the frame-source protocol that the port's prefetcher
reads, in one of two modes:

  gray crops   the mode its `av` and `parallel` decoders serve from a
               container: `read_frame(0)` gives the whole BGR first frame
               (the ROI mask and the stabilisation's pose come from it),
               `enable_gray_crop_stream` switches to the crop the stream
               was drawn for, and `get_gray_crop_window` gives windows of
               gray crops;
  whole frames the prefetcher's `frames` mode, which a segment filter
               needs: `get_window` gives windows of whole BGR frames, views
               of the base clip's frames (traffic.full_frames) with no copy
               a frame.  The source offers it only when it holds them.

Both keep the container source's contract: frame numbers count from 0, a
frame past `end_frame` is a null frame (zeros, number -1), and the frame at
`end_frame` itself, which has no picture, is the last good frame again with
a read error counted (the inclusive end).  There is no encoded path.

Frame n of the stream is frame n mod N of the base clip.  The feed ends
like a live one that stops: once `deadline` (a `time.perf_counter()`
reading) has passed, the window being served is the last, and
`total_frames` and `end_frame` shrink to the frames served, so a reader
that plans by `total_frames` reads no further.  Without a deadline the
stream ends after `max_frames`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

from .traffic import Clip


class StreamSource:
    supports_seek = False
    uniform_timestamps = True

    def __init__(self, clip: Clip, max_frames: int, frames: Optional[np.ndarray] = None):
        """frames: the base clip's whole BGR frames (N, H, W, 3), for
        `get_window`."""
        self._clip = clip
        self._crops = clip.crops
        self._frames = frames
        self.fps = clip.fps
        self.filepath = Path("swtbench.stream")
        self.frame_shape = clip.first_frame.shape
        self.start_frame = 0
        self.end_frame = int(max_frames)
        self.total_frames = int(max_frames)
        self.next_frame_number = 0
        self.frames_read = 0
        self.read_errors = 0
        self.deadline: Optional[float] = None
        self._crop = None
        # the base clip's index of the last good frame served
        self._last_good: Optional[int] = None
        self._null_frame = None if frames is None else np.zeros(frames.shape[1:], np.uint8)

    def read_frame(self, frame_number: int, increment: bool = True):
        """The whole first frame, read before the stream starts; later
        frames come through `get_gray_crop_window` or `get_window`."""
        if frame_number != 0 or increment or self._crop is not None:
            raise RuntimeError("the stream serves BGR frame 0 only, before its gray crops")
        return self._clip.first_frame

    def enable_gray_crop_stream(self, crop_region) -> bool:
        """Whether `crop_region` is the crop the stream was drawn for."""
        want = [tuple(map(int, p)) for p in crop_region]
        if want != [tuple(map(int, p)) for p in self._clip.crop]:
            return False
        self._crop = want
        return True

    def get_gray_crop_window(self, n: int, out: Optional[np.ndarray] = None):
        """n consecutive gray crops: ((n, h, w) uint8, numbers, stamps)."""
        if self._crop is None:
            raise RuntimeError("get_gray_crop_window before enable_gray_crop_stream")
        N, h, w = self._crops.shape
        if out is None:
            out = np.empty((n, h, w), np.uint8)
        fn0 = self.next_frame_number
        if fn0 % N + n <= N and fn0 + n <= self.end_frame:
            # the whole window lies in one loop of the clip: one copy
            out[:] = self._crops[fn0 % N:fn0 % N + n]
            self._last_good = (fn0 + n - 1) % N
            self.next_frame_number += n
            self.frames_read += n
            numbers = list(range(fn0, fn0 + n))
        else:
            numbers = []
            for i, (fn, k) in enumerate(self._walk(n)):
                out[i] = 0 if k is None else self._crops[k]
                numbers.append(fn)
        self._check_deadline()
        return out, numbers, list(numbers)

    def get_window(self, n: int):
        """n consecutive whole BGR frames: (a list of (H, W, 3) uint8 views
        of the base clip's frames, numbers, stamps)."""
        if self._frames is None:
            raise RuntimeError("this stream holds no whole frames")
        frames, numbers = [], []
        for fn, k in self._walk(n):
            frames.append(self._null_frame if k is None else self._frames[k])
            numbers.append(fn)
        self._check_deadline()
        return frames, numbers, list(numbers)

    def _walk(self, n: int) -> list:
        """The next n frames, one by one: (frame number, base clip index).
        A null frame is (-1, None); the frame at `end_frame` is (its
        number, the last good index, or None before any)."""
        N = len(self._crops)
        out = []
        for _ in range(n):
            fn = self.next_frame_number
            if not self.start_frame <= fn <= self.end_frame:
                out.append((-1, None))
                continue
            self.next_frame_number += 1
            if fn < self.end_frame:
                self._last_good = fn % N
                self.frames_read += 1
            else:
                # the inclusive end: no picture, the last good frame again
                self.read_errors += 1
            out.append((fn, self._last_good))
        return out

    def _check_deadline(self) -> None:
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            self.end_frame = self.total_frames = min(self.next_frame_number, self.end_frame)

    def close(self) -> None:
        """Nothing is held open."""
