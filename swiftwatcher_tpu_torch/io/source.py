"""In-memory frame sources with the reference's I/O semantics, pandas-free.

Counterparts of swiftwatcher_tpu/io/readers.py (FrameSource, ArraySource)
and io/synthetic.py (LoopingArraySource):

  * the bounds check is INCLUSIVE of end_frame, so the frame at index
    end_frame is requested; a failed read substitutes the last good frame
    and bumps read_errors (one duplicated tail frame);
  * out-of-range requests yield a zero "null" frame with frame number -1.

Stamps are frame numbers (-1 for null frames): the port recomputes
timestamps as frame_number / fps only where it writes them (CSV export).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class FrameSource:
    """Base frame source; subclasses implement read_frame()."""

    def __init__(self):
        self.fps = 0.0
        self.start_frame = 0
        self.end_frame = 0
        self.total_frames = 0
        self.next_frame_number = 0
        self.frame_shape = (0, 0, 0)
        self.last_read_frame: Optional[np.ndarray] = None
        self.frames_read = 0
        self.read_errors = 0

    def read_frame(self, frame_number: int, increment: bool = True):
        raise NotImplementedError

    def get_frame(self) -> Tuple[np.ndarray, int, int]:
        """(frame, frame_number, stamp) at the cursor, with error fallback."""
        frame_number = self.next_frame_number
        if not self.start_frame <= frame_number <= self.end_frame:
            return np.zeros(self.frame_shape, np.uint8), -1, -1
        frame = self.read_frame(frame_number)
        if frame is None:
            frame = self.last_read_frame
            self.read_errors += 1
        else:
            self.frame_shape = frame.shape
            self.last_read_frame = frame
            self.frames_read += 1
        return frame, frame_number, frame_number

    def get_window(self, n: int) -> Tuple[List[np.ndarray], List[int], List[int]]:
        """n consecutive frames (a list, no copies) + numbers + stamps.

        Null frames read before any real frame have shape (0, 0, 0); they
        are broadcast to the window's frame shape."""
        frames, numbers, stamps = [], [], []
        for _ in range(n):
            f, num, st = self.get_frame()
            frames.append(f)
            numbers.append(num)
            stamps.append(st)

        def real(f):
            return f is not None and f.size

        shape = next((f.shape for f in frames if real(f)), None)
        if shape is None and self.frame_shape != (0, 0, 0):
            shape = self.frame_shape
        if shape is not None:
            frames = [f if real(f) else np.zeros(shape, np.uint8) for f in frames]
        elif any(f is None for f in frames):
            raise RuntimeError(
                "every read in the first window failed before any frame "
                "established the source's geometry"
            )
        return frames, numbers, stamps


class ArraySource(FrameSource):
    """(N, H, W, 3) uint8 frames held in memory (tests, benches)."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0, start: int = 0, end: int = 0):
        super().__init__()
        self._frames = np.asarray(frames, np.uint8)
        self.fps = float(fps)
        self.start_frame = start
        self.end_frame = end if end > 0 else len(self._frames)
        self.next_frame_number = self.start_frame
        self.total_frames = self.end_frame - self.start_frame

    def read_frame(self, frame_number: int, increment: bool = True):
        frame = self._frames[frame_number] if frame_number < len(self._frames) else None
        if increment:
            self.next_frame_number += 1
        return frame


class LoopingArraySource(ArraySource):
    """Serves `total` frames by cycling a base clip (bounded host memory)."""

    def __init__(self, base_frames: np.ndarray, total: int, fps: float = 30.0):
        super().__init__(np.asarray(base_frames, np.uint8), fps=fps)
        self.end_frame = total
        self.total_frames = total

    def read_frame(self, frame_number: int, increment: bool = True):
        frame = (
            self._frames[frame_number % len(self._frames)]
            if frame_number < self.total_frames
            else None
        )
        if increment:
            self.next_frame_number += 1
        return frame
