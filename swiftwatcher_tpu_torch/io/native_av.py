"""ctypes bindings of the libav container decoder (native/avpump.cpp).

The port's copy of swiftwatcher_tpu/io/native_av.py.  A library of its own,
separate from the frame pump's: it links the system FFmpeg libraries
(libavformat, libavcodec, libswscale, libavutil), which a host may lack,
and then only this backend is missing.  Built by g++ at first use into
build/native/ (swiftwatcher_tpu_torch/build.py:load_native).

The caller gates every use on a probe of the file at hand: probe_bgr_parity
(the first frames byte-equal to cv2's, whose FFmpeg is a build of its
own), probe_native_seek (keyframe seek + decode forward equal to a
sequential decode) and probe_gray_crop_parity (the gray-crop stream equal
to graying the BGR frame).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .. import build
from ..ops.color import bgr_to_gray_host

_U8P = ctypes.POINTER(ctypes.c_uint8)
_INT = ctypes.c_int
_I64P = ctypes.POINTER(ctypes.c_int64)


def _bind(lib: ctypes.CDLL) -> None:
    lib.swt_av_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_INT),
                                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_INT),
                                ctypes.POINTER(_INT), _INT]
    lib.swt_av_open.restype = ctypes.c_void_p
    lib.swt_av_read_bgr.argtypes = [ctypes.c_void_p, _U8P, _INT, _INT,
                                    ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
    lib.swt_av_read_bgr.restype = _INT
    lib.swt_av_read_null.argtypes = [ctypes.c_void_p]
    lib.swt_av_read_null.restype = _INT
    lib.swt_av_close.argtypes = [ctypes.c_void_p]
    lib.swt_av_close.restype = None
    lib.swt_av_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.swt_av_seek.restype = _INT
    lib.swt_av_keyframes.argtypes = [ctypes.c_void_p, _I64P, _INT]
    lib.swt_av_keyframes.restype = _INT
    lib.swt_av_read_gray_crop.argtypes = [ctypes.c_void_p, _INT, _INT, _INT, _INT, _U8P]
    lib.swt_av_read_gray_crop.restype = _INT
    lib.swt_av_write_test.argtypes = [ctypes.c_char_p, _U8P, _INT, _INT, _INT,
                                      ctypes.c_double, ctypes.c_char_p]
    lib.swt_av_write_test.restype = _INT
    lib.swt_av_write_test_pts.argtypes = [ctypes.c_char_p, _U8P, _INT, _INT, _INT, _INT,
                                          _I64P, ctypes.c_char_p]
    lib.swt_av_write_test_pts.restype = _INT


def _load() -> Optional[ctypes.CDLL]:
    return build.load_native(
        "avpump", ("-lavformat", "-lavcodec", "-lswscale", "-lavutil"), _bind)


def is_available() -> bool:
    return _load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


class AVReader:
    """Sequential libav decoder of general containers (H.264 or MPEG-4 in
    MP4, ...), with libavcodec's frame threads.  read() returns the next
    (H, W, 3) uint8 BGR frame, or None at the end of the stream or on a
    decode error (the stream advances either way, as a failed cv2 retrieve
    does)."""

    def __init__(self, lib, handle, n_frames, fps, width, height):
        self._lib = lib
        self._handle = handle
        self.n_frames = n_frames
        self.fps = fps
        self.width = width
        self.height = height
        # reads and seeks must not run while close() frees the handle
        self._rw_lock = threading.Lock()

    @classmethod
    def open(cls, path, n_threads: int = 0) -> Optional["AVReader"]:
        """None without the library or for a file libav cannot open."""
        lib = _load()
        if lib is None:
            return None
        n, fps, w, h = _INT(0), ctypes.c_double(0.0), _INT(0), _INT(0)
        handle = lib.swt_av_open(str(path).encode(), ctypes.byref(n), ctypes.byref(fps),
                                 ctypes.byref(w), ctypes.byref(h), n_threads)
        if not handle:
            return None
        return cls(lib, handle, n.value, fps.value, w.value, h.value)

    def read_null(self) -> bool:
        """Decode the next frame and drop it (no conversion, no copy): the
        rate of a loop of these is libavcodec's decode floor for the
        stream.  False at the end of the stream or on an error."""
        with self._rw_lock:
            if not self._handle:
                return False
            return self._lib.swt_av_read_null(self._handle) == 0

    def read(self) -> Optional[np.ndarray]:
        out = np.empty(self.height * self.width * 3, np.uint8)
        h, w = _INT(0), _INT(0)
        with self._rw_lock:
            if not self._handle:
                return None
            rc = self._lib.swt_av_read_bgr(self._handle, _u8ptr(out), self.height, self.width,
                                           ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            return None
        return out[: h.value * w.value * 3].reshape(h.value, w.value, 3)

    def keyframes(self) -> Optional[np.ndarray]:
        """Frame numbers of the container's keyframes (int64, ascending),
        from its index without decoding; None when the format has no usable
        index.  ParallelDecoder aligns its chunks to them."""
        cap = max(int(self.n_frames or 0), 1) + 1
        out = np.empty(cap, np.int64)
        with self._rw_lock:
            if not self._handle:
                return None
            n = self._lib.swt_av_keyframes(self._handle, out.ctypes.data_as(_I64P), cap)
        return out[:n].copy() if n > 0 else None

    def seek(self, frame_number: int) -> bool:
        """Position the stream so that the next read returns
        `frame_number` (keyframe seek, then decode forward); False when the
        stream's stamps are unusable or the target is at or past its end."""
        with self._rw_lock:
            if not self._handle:
                return False
            return self._lib.swt_av_seek(self._handle, int(frame_number)) == 0

    def read_gray_crop(self, crop_region) -> Optional[np.ndarray]:
        """The next frame as its (y2-y1, x2-x1) uint8 gray crop, converting
        only the crop's rows (no full BGR frame); None at the end of the
        stream or on a decode error.  Engage only where
        probe_gray_crop_parity passed for this file and crop."""
        (x1, y1), (x2, y2) = crop_region
        out = np.empty((y2 - y1, x2 - x1), np.uint8)
        with self._rw_lock:
            if not self._handle:
                return None
            rc = self._lib.swt_av_read_gray_crop(self._handle, y1, y2, x1, x2, _u8ptr(out))
        return out if rc == 0 else None

    def close(self) -> None:
        with self._rw_lock:
            if self._handle:
                self._lib.swt_av_close(self._handle)
                self._handle = None

    def __del__(self):
        self.close()


def write_test_video(path, frames: np.ndarray, fps: float = 25.0,
                     codec: str = "libx264") -> bool:
    """Encode (N, H, W, 3) uint8 BGR frames into an MP4 through a system
    encoder (cv2's bundled FFmpeg has no H.264 encoder); False when the
    library or the encoder is missing."""
    lib = _load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    return lib.swt_av_write_test(str(path).encode(), _u8ptr(frames), n, h, w, float(fps),
                                 codec.encode()) == 0


def write_test_video_vfr(path, frames: np.ndarray, pts_seconds, timebase_den: int = 90000,
                         codec: str = "libx264") -> bool:
    """Encode (N, H, W, 3) uint8 BGR frames into a variable-frame-rate MP4:
    frame i is presented at pts_seconds[i]."""
    lib = _load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    pts = np.asarray(np.round(np.asarray(pts_seconds, np.float64) * timebase_den), np.int64)
    if len(pts) != n or (np.diff(pts) <= 0).any():
        raise ValueError("pts_seconds must give one strictly ascending stamp per frame")
    return lib.swt_av_write_test_pts(str(path).encode(), _u8ptr(frames), n, h, w,
                                     int(timebase_den), pts.ctypes.data_as(_I64P),
                                     codec.encode()) == 0


def probe_native_seek(path, n_probe: int = 12, seek_at: int = 8) -> bool:
    """True when AVReader.seek reproduces a sequential decode byte for byte
    on this file: near its head against the sequential frames, and at 50%
    and 90% of the stream by two seek origins that must agree (as
    parallel_decode.probe_seek_accuracy does for cv2)."""
    rd = AVReader.open(path)
    if rd is None:
        return False
    try:
        seq = [rd.read() for _ in range(n_probe)]
        if seq[0] is None or seek_at >= n_probe or seq[seek_at] is None:
            return False
        for pos in {seek_at, max(seek_at // 2, 1)}:
            if not rd.seek(pos):
                return False
            got = rd.read()
            if got is None or not np.array_equal(seq[pos], got):
                return False
        total = rd.n_frames
        if total and total > 4 * n_probe:
            back = 7
            for frac in (0.5, 0.9):
                tgt = min(int(total * frac), total - 1)
                if not rd.seek(tgt):
                    return False
                direct = rd.read()
                if direct is None or not rd.seek(tgt - back):
                    return False
                stepped = None
                for _ in range(back + 1):
                    stepped = rd.read()
                    if stepped is None:
                        return False
                if not np.array_equal(direct, stepped):
                    return False
        return True
    finally:
        rd.close()


def probe_gray_crop_parity(path, crop_region, n_probe: int = 2) -> bool:
    """True when read_gray_crop equals the gray of read()'s frame, cropped,
    byte for byte on the first frames of this file at this crop."""
    rd_a = AVReader.open(path)
    rd_b = AVReader.open(path)
    try:
        if rd_a is None or rd_b is None:
            return False
        (x1, y1), (x2, y2) = crop_region
        for _ in range(n_probe):
            full = rd_a.read()
            fast = rd_b.read_gray_crop(crop_region)
            if full is None or fast is None:
                return False
            if not np.array_equal(bgr_to_gray_host(full[y1:y2, x1:x2]), fast):
                return False
        return True
    finally:
        for rd in (rd_a, rd_b):
            if rd is not None:
                rd.close()


def probe_bgr_parity(path, n_probe: int = 3) -> Optional[AVReader]:
    """Open `path` with libav and hold its first `n_probe` frames, its
    frame count and its fps to cv2's.  A new AVReader at frame 0 when they
    agree byte for byte, else None."""
    rd = AVReader.open(path)
    if rd is None:
        return None
    try:
        import cv2

        cap = cv2.VideoCapture(str(path))
        try:
            if not cap.isOpened():
                return None
            cv_fps = float(cap.get(cv2.CAP_PROP_FPS))
            cv_n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if cv_n != rd.n_frames or abs(cv_fps - rd.fps) > 1e-6 * max(cv_fps, 1.0):
                return None
            for _ in range(n_probe):
                ok, ref = cap.read()
                mine = rd.read()
                if not ok:
                    # a container shorter than the probe: both must end
                    if mine is not None:
                        return None
                    break
                if mine is None or not np.array_equal(ref, mine):
                    return None
        finally:
            cap.release()
    finally:
        rd.close()
    return AVReader.open(path)
