"""Frame sources with the reference's I/O semantics, pandas-free.

Counterparts of swiftwatcher_tpu/io/readers.py (FrameSource, ArraySource,
HDF5Source, VideoFileSource with its four decode backends, open_source)
and io/synthetic.py (LoopingArraySource):

  * the bounds check is INCLUSIVE of end_frame, so the frame at index
    end_frame is requested; a failed read substitutes the last good frame
    and bumps read_errors (one duplicated tail frame);
  * out-of-range requests yield a zero "null" frame with frame number -1;
  * a container is read as the reference reads it, in sequence (retrieve,
    then grab), and --start is ignored for it (io_video.py:146,155-165);
    the parallel and av backends give cv2's frames, each engaging only
    where a probe of the file shows it does; the native MJPG reader gives
    libjpeg's decode of them.

Stamps are frame numbers (-1 for null frames): the port recomputes
timestamps as frame_number / fps only where it writes them (CSV export).
"""

from __future__ import annotations

import abc
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops.color import bgr_to_gray_host


class FrameSource(abc.ABC):
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

    @abc.abstractmethod
    def read_frame(self, frame_number: int, increment: bool = True):
        """The frame at `frame_number` (None on a decode failure); advance
        the cursor when `increment`."""

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




class HDF5Source(FrameSource):
    """An HDF5 file of per-frame encoded images (io_video.py:85-131): the
    dataset "VideoFrames", fps and frame count from the CAP_PROP_* attrs
    of the file or the dataset, frames decoded by cv2.imdecode.  Honours
    --start, as the reference's HDF5 reader does."""

    def __init__(self, filepath, start: int = 0, end: int = 0):
        super().__init__()
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{filepath}: reading an HDF5 clip needs h5py, which is not installed; "
                "save the frames as a .npy clip ((N, H, W, 3) uint8 BGR) or a video "
                "container (MP4, MJPG AVI) instead"
            ) from e
        self.filepath = Path(filepath)
        self._file = h5py.File(str(filepath), "r")
        self._dset = self._file["VideoFrames"]
        attrs = self._file.attrs if len(self._file.attrs) > 0 else self._dset.attrs
        if attrs.get("CAP_PROP_FPS") is None or attrs.get("CAP_PROP_FRAME_COUNT") is None:
            raise RuntimeError(
                f"{filepath}: the HDF5 file or its dataset must carry the CAP_PROP_FPS "
                "and CAP_PROP_FRAME_COUNT attrs"
            )
        self.fps = float(attrs.get("CAP_PROP_FPS"))
        self.start_frame = start
        self.end_frame = end if end > 0 else int(attrs.get("CAP_PROP_FRAME_COUNT"))
        self.next_frame_number = self.start_frame
        self.total_frames = self.end_frame - self.start_frame
        self._last_encoded = None

    def _encoded(self, frame_number: int) -> bytes:
        """The slot's payload; raises ValueError or IndexError for a slot
        that is missing, or empty (an unwritten variable-length slot reads
        back with length 0)."""
        enc = bytes(np.asarray(self._dset[frame_number]))
        if not enc:
            raise ValueError("empty encoded slot")
        return enc

    def read_frame(self, frame_number: int, increment: bool = True):
        import cv2

        try:
            frame = cv2.imdecode(np.frombuffer(self._encoded(frame_number), np.uint8),
                                 cv2.IMREAD_COLOR)
        except (ValueError, IndexError, cv2.error):
            # old h5py raises ValueError past the end, new h5py IndexError, a
            # corrupt buffer cv2.error: the same decode-failure fallback
            frame = None
        if increment:
            self.next_frame_number += 1
        return frame

    def peek_encoded(self, frame_number: int) -> Optional[bytes]:
        """A slot's payload without any bookkeeping (None for a missing or
        empty slot): lets a caller sniff the codec up front."""
        try:
            return self._encoded(frame_number)
        except (ValueError, IndexError):
            return None

    def get_encoded_window(self, n: int):
        """get_window one level earlier: (payloads, numbers, stamps), where
        a payload is bytes, or None for a null frame.  The inclusive end's
        failed read reuses the last good payload (and counts the error), so
        a decoder downstream reproduces the reference's substitution; a
        failure before any good payload stays None, and its decode failure
        downstream is the one error counted."""
        bufs, numbers, stamps = [], [], []
        for _ in range(n):
            fn = self.next_frame_number
            if not self.start_frame <= fn <= self.end_frame:
                bufs.append(None)
                numbers.append(-1)
                stamps.append(-1)
                continue
            try:
                enc = self._encoded(fn)
                self._last_encoded = enc
                self.frames_read += 1
            except (ValueError, IndexError):
                enc = self._last_encoded
                if enc is not None:
                    self.read_errors += 1
            self.next_frame_number += 1
            bufs.append(enc)
            numbers.append(fn)
            stamps.append(fn)
        return bufs, numbers, stamps

    def close(self) -> None:
        self._file.close()


def _decode_workers(decode_workers: Optional[int]) -> int:
    """The worker count asked for, else $SWTPU_DECODE_WORKERS, else one
    per core (the JAX package's readers.py:312-315)."""
    if decode_workers is not None:
        return decode_workers
    return int(os.environ.get("SWTPU_DECODE_WORKERS", os.cpu_count() or 1))


class VideoFileSource(FrameSource):
    """A video container (io_video.py:134-165), through one of four
    backends that all give the reference's frames (a failed decode yields
    None, which get_frame replaces by the last good frame; --start is
    ignored):

      native:   MJPG AVIs through the first-party parser and libjpeg
                (native/framepump.cpp);
      parallel: containers whose seek is frame-accurate (a probe decides),
                decoded by chunk-claiming workers (io/parallel_decode.py);
                it makes the source seekable, so a checkpoint can resume;
      av:       the system's libav with frame threads (native/avpump.cpp),
                where the first frames are byte-equal to cv2's (a probe
                decides); seekable where its keyframe seek is exact;
      cv2:      cv2.VideoCapture in sequence, the reference's own reader.

    backend="auto" tries them in that order (parallel only with more than
    one decode worker); a backend asked for by name raises where it cannot
    engage.  `backend` tells which one did."""

    supports_seek = False

    def __init__(self, filepath, end: int = 0, backend: str = "auto",
                 decode_workers: Optional[int] = None):
        super().__init__()
        if backend not in ("auto", "native", "parallel", "av", "cv2"):
            raise ValueError(f"unknown decode backend {backend!r}")
        self.filepath = Path(filepath)
        self.backend = "cv2"
        self.decode_workers = 1
        self._cap = None
        self._avi = None
        self._pdec = None
        self._avrd = None
        self._kf_bounds = None
        self._pos = 0             # frame number held in self._current (native, av)
        self._gray_crop = None    # crop region once the gray-crop stream engages
        self._gray_current = None
        self._last_good_gray = None
        if backend in ("auto", "native"):
            from . import native

            self._avi = native.AVIReader.open(filepath)
        if self._avi is not None:
            self.backend = "native"
            self.fps = float(self._avi.fps)
            self._frame_hw = (self._avi.height, self._avi.width)
            self.end_frame = end if end > 0 else self._avi.n_frames
            self._current = self._avi.read()  # prime frame 0
        else:
            if backend == "native":
                raise ValueError(f"{filepath}: not an MJPG AVI (or no native frame pump)")
            self._open_container(filepath, end, backend, _decode_workers(decode_workers))
        self.next_frame_number = self.start_frame
        self.total_frames = self.end_frame - self.start_frame

    def _open_container(self, filepath, end: int, backend: str, workers: int) -> None:
        import cv2

        self._cap = cv2.VideoCapture(str(filepath))
        if not self._cap.isOpened():
            raise RuntimeError(
                f"{filepath}: cv2.VideoCapture could not open the file "
                "(missing, unreadable, or unsupported container)"
            )
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self._frame_hw = (int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                          int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        container_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.end_frame = end if end > 0 else container_frames
        want_parallel = backend == "parallel" or (backend == "auto" and workers > 1)
        if want_parallel and container_frames > 0:
            from . import native_av
            from .parallel_decode import ParallelDecoder, probe_seek_accuracy

            if probe_seek_accuracy(filepath, container_frames):
                self._cap.release()
                self._cap = None
                # chunks aligned to the container's keyframes (from its
                # index, without decoding) spare each worker's seek a
                # decode of up to a GOP; without libav, fixed chunks
                kf_reader = native_av.AVReader.open(filepath)
                if kf_reader is not None:
                    kfs = kf_reader.keyframes()
                    kf_reader.close()
                    if kfs is not None and len(kfs) > 1:
                        self._kf_bounds = [int(k) for k in kfs]
                self._pdec = ParallelDecoder(filepath, container_frames, n_workers=workers,
                                             boundaries=self._kf_bounds)
                self.decode_workers = workers
                self.backend = "parallel"
                self.supports_seek = True
                self._p_cached = None
                self._p_cached_fn = -1
            elif backend == "parallel":
                raise ValueError(
                    f"{filepath}: seek is not frame-accurate on this container; "
                    "a parallel decode would corrupt frames"
                )
        if self.backend == "cv2" and backend in ("auto", "av"):
            from . import native_av

            self._avrd = native_av.probe_bgr_parity(filepath)
            if self._avrd is not None:
                self._cap.release()
                self._cap = None
                self.backend = "av"
                self._current = self._avrd.read()  # prime frame 0
                # keyframe seek + decode forward equals a sequential decode
                # where the probe passes: a checkpoint can resume then
                if native_av.probe_native_seek(filepath):
                    self.supports_seek = True
            elif backend == "av":
                raise ValueError(
                    f"{filepath}: libav decode unavailable or not byte-equal to cv2 "
                    "on this file"
                )
        if self.backend == "cv2":
            self._cap.grab()  # prime, so that retrieve() returns frame 0

    def read_frame(self, frame_number: int, increment: bool = True):
        if self._gray_crop is not None:
            # after the gray-crop stream engages, the decoder's cursor (and,
            # on parallel, its frames) belong to get_gray_crop_window
            raise RuntimeError("read_frame after enable_gray_crop_stream: "
                               "use get_gray_crop_window")
        if self.backend in ("native", "av"):
            if self.backend == "av" and frame_number != self._pos and self.supports_seek:
                # a jump (checkpoint resume): re-aim by the probed keyframe
                # seek; one at or past the end yields None, a decode failure
                self._current = self._avrd.read() if self._avrd.seek(frame_number) else None
                self._pos = frame_number
            frame = self._current
            if increment:
                rd = self._avi if self.backend == "native" else self._avrd
                self._current = rd.read()
                self._pos += 1
                self.next_frame_number += 1
            return frame
        if self.backend == "parallel":
            if frame_number == self._p_cached_fn:
                frame = self._p_cached
            else:
                if frame_number != self._p_cached_fn + 1:
                    self._pdec.restart(frame_number)  # a jump: re-aim the workers
                frame = self._pdec.get(frame_number)
                self._p_cached, self._p_cached_fn = frame, frame_number
            if increment:
                self.next_frame_number += 1
            return frame
        ok, frame = self._cap.retrieve()
        if not ok:
            frame = None
        if increment:
            self._cap.grab()
            self.next_frame_number += 1
        return frame

    def enable_gray_crop_stream(self, crop_region) -> bool:
        """Switch to decoding straight to gray crops: libav converts only the
        crop's rows and emits the shift-15 gray crop, never a full BGR frame
        (avpump.cpp swt_av_read_gray_crop).  On the parallel backend, its
        workers become libav gray-crop workers.  Engages only for a crop
        inside the frame and where probe_gray_crop_parity (and, for
        parallel, probe_native_seek) pass on this file; returns whether it
        did, changing nothing otherwise.  Call before the first window;
        then read windows through get_gray_crop_window only."""
        if self._gray_crop is not None:
            return self._gray_crop == crop_region
        if self.backend not in ("av", "parallel"):
            return False
        from . import native_av

        if self.backend == "av":
            H, W = (self._current.shape[:2] if self._current is not None
                    else (self._avrd.height, self._avrd.width))
        else:
            H, W = self._frame_hw
        (x1, y1), (x2, y2) = crop_region
        if not (0 <= y1 < y2 <= H and 0 <= x1 < x2 <= W):
            return False  # an out-of-bounds crop needs python-slice semantics
        if not native_av.probe_gray_crop_parity(self.filepath, crop_region):
            return False
        if self.backend == "parallel":
            # the gray workers re-aim chunks by libav's keyframe seek, which
            # needs a probe of its own (cv2's seek engaged this backend)
            if not native_av.probe_native_seek(self.filepath):
                return False
            from .parallel_decode import ParallelDecoder, gray_crop_worker_factory

            old = self._pdec
            self._pdec = ParallelDecoder(
                self.filepath, old.total, n_workers=self.decode_workers,
                start=self.next_frame_number,
                worker_factory=gray_crop_worker_factory(crop_region),
                boundaries=self._kf_bounds)
            old.close()
            self._pos = self.next_frame_number
            self._gray_crop = crop_region
            return True
        self._gray_crop = crop_region
        # frame 0 was primed as BGR at open: its gray crop, by the same
        # formula the stream applies
        self._gray_current = (None if self._current is None
                              else bgr_to_gray_host(self._current[y1:y2, x1:x2]))
        return True

    def get_gray_crop_window(self, n: int, out: Optional[np.ndarray] = None):
        """get_window at the gray-crop level (after enable_gray_crop_stream),
        with the same null frames, decode-failure substitution and
        inclusive end, as HDF5Source.get_encoded_window does one level
        earlier: ((n, ch, cw) uint8, numbers, stamps).  `out`, when given,
        receives the crops (a pinned buffer's view)."""
        crop = self._gray_crop
        (x1, y1), (x2, y2) = crop
        ch, cw = y2 - y1, x2 - x1
        if out is None:
            out = np.empty((n, ch, cw), np.uint8)
        numbers, stamps = [], []
        for i in range(n):
            fn = self.next_frame_number
            if not self.start_frame <= fn <= self.end_frame:
                out[i] = 0
                numbers.append(-1)
                stamps.append(-1)
                continue
            if self.backend == "parallel":
                if fn != self._pos:
                    self._pdec.restart(fn)  # a jump: re-aim the workers
                g = self._pdec.get(fn)
                self._pos = fn + 1
            else:
                if fn != self._pos:
                    # a jump: re-aim the stream
                    ok = self.supports_seek and self._avrd.seek(fn)
                    self._gray_current = self._avrd.read_gray_crop(crop) if ok else None
                    self._pos = fn
                g = self._gray_current
                self._gray_current = self._avrd.read_gray_crop(crop)
                self._pos += 1
            self.next_frame_number += 1
            if g is None:
                # a decode failure: the last good crop, and the error counted
                self.read_errors += 1
                g = self._last_good_gray
            else:
                self.frames_read += 1
                self._last_good_gray = g
            out[i] = 0 if g is None else g
            numbers.append(fn)
            stamps.append(fn)
        return out, numbers, stamps

    def close(self) -> None:
        for reader in (self._pdec, self._avrd, self._avi):
            if reader is not None:
                reader.close()
        if self._cap is not None:
            self._cap.release()


def open_source(filepath, start: int = 0, end: int = 0) -> FrameSource:
    """Pick a source by suffix (__main__.py:23-26): .h5/.hdf5 files, .npy
    clips in memory, anything else a video container through the first
    decode backend that engages on it."""
    p = Path(filepath)
    if p.suffix in (".h5", ".hdf5"):
        return HDF5Source(p, start, end)
    if p.suffix == ".npy":
        src = ArraySource(np.load(p), fps=30.0, start=start, end=end)
        src.filepath = p
        return src
    return VideoFileSource(p, end)
