"""Frame sources with the reference's I/O semantics, pandas-free.

Counterparts of swiftwatcher_tpu/io/readers.py (FrameSource, ArraySource,
the cv2 backend of VideoFileSource, open_source) and io/synthetic.py
(LoopingArraySource):

  * the bounds check is INCLUSIVE of end_frame, so the frame at index
    end_frame is requested; a failed read substitutes the last good frame
    and bumps read_errors (one duplicated tail frame);
  * out-of-range requests yield a zero "null" frame with frame number -1;
  * a container is read strictly in sequence (retrieve, then grab) and
    --start is ignored for it (io_video.py:146,155-165).

Stamps are frame numbers (-1 for null frames): the port recomputes
timestamps as frame_number / fps only where it writes them (CSV export).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


class FrameSource:
    """Base frame source; subclasses implement read_frame()."""

    #: whether read_frame honours any frame_number (random access); a
    #: sequential source cannot resume from a checkpoint
    supports_seek = True

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
        self.filepath: Optional[Path] = None

    def read_frame(self, frame_number: int, increment: bool = True):
        raise NotImplementedError

    def close(self) -> None:
        """Release what the source holds open (nothing, in memory)."""

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
        # the JAX package's name for in-memory clips (segment PNG names)
        self.filepath = Path("synthetic.mem")

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


# ROADMAP.md item of the readers the port does not have yet.
_READERS_ITEM = "ROADMAP.md section 1 item 3, readers"


class VideoFileSource(FrameSource):
    """A container read through cv2.VideoCapture, in sequence: the cv2
    backend of swiftwatcher_tpu/io/readers.py:VideoFileSource.  A failed
    decode yields None, which get_frame replaces by the last good frame."""

    supports_seek = False

    def __init__(self, filepath, end: int = 0, backend: str = "cv2"):
        super().__init__()
        if backend != "cv2":
            raise NotImplementedError(
                f"the {backend!r} decode backend is not ported yet ({_READERS_ITEM}); "
                "the port reads containers through cv2"
            )
        import cv2

        self.filepath = Path(filepath)
        self._cap = cv2.VideoCapture(str(filepath))
        if not self._cap.isOpened():
            raise RuntimeError(
                f"{filepath}: cv2.VideoCapture could not open the file "
                "(missing, unreadable, or unsupported container)"
            )
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        container_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.end_frame = end if end > 0 else container_frames
        self._cap.grab()  # prime, so that retrieve() returns frame 0
        self.next_frame_number = self.start_frame
        self.total_frames = self.end_frame - self.start_frame

    def read_frame(self, frame_number: int, increment: bool = True):
        ok, frame = self._cap.retrieve()
        if not ok:
            frame = None
        if increment:
            self._cap.grab()
            self.next_frame_number += 1
        return frame

    def close(self) -> None:
        self._cap.release()


def open_source(filepath, start: int = 0, end: int = 0) -> FrameSource:
    """Pick a source by suffix (__main__.py:23-26): .npy clips in memory,
    anything else a container through cv2."""
    p = Path(filepath)
    if p.suffix in (".h5", ".hdf5"):
        raise NotImplementedError(f"HDF5 sources are not ported yet ({_READERS_ITEM})")
    if p.suffix == ".npy":
        src = ArraySource(np.load(p), fps=30.0, start=start, end=end)
        src.filepath = p
        return src
    return VideoFileSource(p, end)
