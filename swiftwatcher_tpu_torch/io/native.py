"""ctypes bindings of the native frame pump (native/framepump.cpp), of the
wire codec's encoders (csrc/wire_encode.cpp) and of the frames mode's gray
crop (csrc/gray_crop.cpp).

The port's copy of swiftwatcher_tpu/io/native.py.  The libraries are built
by g++ at first use into build/native/
(swiftwatcher_tpu_torch/build.py:load_native).  The frame pump links
libjpeg, and its entry points are gated by `is_available()`: without g++ or
libjpeg the callers take the cv2 or numpy paths, which give the same bytes.
The encoders and the gray crop are libraries of their own that need no
libjpeg (a host without it still has them), gated by `has_symbol()`;
without g++ the numpy encoders of io/wirecodec.py and ops/color.py's
bgr_to_gray_host give the same bytes.

  * gray_crop_batch (frame pump) / gray_crop_frames (gray crop library):
    BGR -> the shift-15 grayscale crop, bit-equal to
    ops/color.py:bgr_to_gray_host, off the GIL; gray_crop_frames takes a
    window of frames where each lies and crops them in threads;
  * decode_jpeg_bgr and decode_window_gray: libjpeg decode (of HDF5
    frames), the latter straight to gray crops;
  * AVIReader: MJPG-in-AVI through the first-party container parser;
  * encode_delta4 / encode_delta6: the wire codec's encoders, threaded,
    bit-equal to io/wirecodec.py's numpy encoders.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from .. import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_INT = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    lib.swt_gray_crop_batch.argtypes = [_U8P, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                        _U8P, _INT]
    lib.swt_gray_crop_batch.restype = None
    lib.swt_decode_jpeg_bgr.argtypes = [_U8P, ctypes.c_size_t, _U8P, _INT, _INT,
                                        ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
    lib.swt_decode_jpeg_bgr.restype = _INT
    lib.swt_decode_window_gray.argtypes = [_U8P, ctypes.POINTER(ctypes.c_int64), _INT,
                                           _INT, _INT, _INT, _INT, _INT, _INT, _U8P, _U8P,
                                           _INT]
    lib.swt_decode_window_gray.restype = _INT
    lib.swt_avi_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_INT),
                                 ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_INT),
                                 ctypes.POINTER(_INT)]
    lib.swt_avi_open.restype = ctypes.c_void_p
    lib.swt_avi_read_bgr.argtypes = [ctypes.c_void_p, _U8P, _INT, _INT,
                                     ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
    lib.swt_avi_read_bgr.restype = _INT
    lib.swt_avi_close.argtypes = [ctypes.c_void_p]
    lib.swt_avi_close.restype = None


def _load() -> Optional[ctypes.CDLL]:
    return build.load_native("framepump", ("-ljpeg", "-lpthread"), _bind)


def is_available() -> bool:
    return _load() is not None


_I64 = ctypes.c_int64
_I32P = ctypes.POINTER(ctypes.c_int32)


def _bind_wire(lib: ctypes.CDLL) -> None:
    lib.swt_encode_delta4.argtypes = [_U8P, _I64, _I64, _U8P, _I32P, _U8P, _I64, _INT]
    lib.swt_encode_delta4.restype = _I64
    lib.swt_encode_delta6.argtypes = [_U8P, _I64, _I64, _INT, _U8P, _U8P, _U8P, _U8P, _I64,
                                      ctypes.POINTER(_I64), _I32P, _U8P, _I64,
                                      ctypes.POINTER(_I64), _INT]
    lib.swt_encode_delta6.restype = _INT


def _load_wire() -> Optional[ctypes.CDLL]:
    return build.load_native("wire_encode", ("-lpthread",), _bind_wire)


def _bind_gray(lib: ctypes.CDLL) -> None:
    lib.swt_gray_crop_frames.argtypes = [ctypes.POINTER(_U8P), ctypes.POINTER(_I64), _INT,
                                         _INT, _INT, _INT, _INT, _U8P, _INT]
    lib.swt_gray_crop_frames.restype = None


def _load_gray() -> Optional[ctypes.CDLL]:
    return build.load_native("gray_crop", ("-lpthread",), _bind_gray)


def has_symbol(name: str) -> bool:
    """True when the library that needs no libjpeg and holds `name` is
    built here and exports it: the wire encoders' (swt_encode_delta4,
    swt_encode_delta6) or the gray crop's (swt_gray_crop_frames)."""
    lib = (_load_gray if name.startswith("swt_gray_") else _load_wire)()
    return lib is not None and getattr(lib, name, None) is not None


def encode_delta4(gray2d: np.ndarray, escape_cap: int, n_threads: int = 4):
    """Threaded C twin of io/wirecodec.py's numpy delta4 encoder, bit-equal.

    gray2d: (N, P) uint8 contiguous frames.  Returns (packed, esc_idx,
    esc_val), or None on escape overflow."""
    lib = _load_wire()
    if lib is None:
        raise RuntimeError("the wire encoders are not available (g++ missing)")
    gray2d = np.ascontiguousarray(gray2d, np.uint8)
    N, P = gray2d.shape
    m = (N - 1) * P
    packed = np.empty((m + 1) // 2, np.uint8)
    esc_idx = np.empty(escape_cap, np.int32)
    esc_val = np.empty(escape_cap, np.uint8)
    rc = lib.swt_encode_delta4(_u8ptr(gray2d), N, P, _u8ptr(packed),
                               esc_idx.ctypes.data_as(_I32P), _u8ptr(esc_val), escape_cap,
                               n_threads)
    if rc < 0:
        return None
    return packed, esc_idx, esc_val


def encode_delta6(gray2d: np.ndarray, escape_cap: int, mode: int = -1, n_threads: int = 4):
    """Threaded C twin of io/wirecodec.py's numpy delta6 encoder, bit-equal.

    gray2d: (N, P) uint8 contiguous frames.  mode: -1 picks the cheaper
    predictor, 0 the batch mean, 1 the previous frame.  Returns (mode, bg,
    lvl1, lvl2, esc_idx, esc_val), lvl2 cut to its exact size (at least one
    byte), or None on a level-3 overflow."""
    lib = _load_wire()
    if lib is None:
        raise RuntimeError("the wire encoders are not available (g++ missing)")
    gray2d = np.ascontiguousarray(gray2d, np.uint8)
    N, P = gray2d.shape
    mode_out = np.zeros(1, np.uint8)
    bg = np.empty(P, np.uint8)
    lvl1 = np.empty((N, (P + 2) // 3), np.uint8)
    lvl2_cap = (N * P + 1) // 2 + 1      # every pixel escapes
    lvl2 = np.zeros(lvl2_cap, np.uint8)
    n1, n3 = _I64(0), _I64(0)
    esc_idx = np.empty(escape_cap, np.int32)
    esc_val = np.empty(escape_cap, np.uint8)
    rc = lib.swt_encode_delta6(_u8ptr(gray2d), N, P, mode, _u8ptr(mode_out), _u8ptr(bg),
                               _u8ptr(lvl1), _u8ptr(lvl2), lvl2_cap, ctypes.byref(n1),
                               esc_idx.ctypes.data_as(_I32P), _u8ptr(esc_val), escape_cap,
                               ctypes.byref(n3), n_threads)
    if rc != 0:
        return None
    return int(mode_out[0]), bg, lvl1, lvl2[: max((n1.value + 1) // 2, 1)].copy(), esc_idx, esc_val


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _out(shape, out: Optional[np.ndarray]) -> np.ndarray:
    """`out` checked against `shape` (a writable contiguous u8 array), or
    a new array."""
    if out is None:
        return np.empty(shape, np.uint8)
    if out.shape != tuple(shape) or out.dtype != np.uint8 or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError(f"out: want a writable contiguous uint8 array of shape {tuple(shape)}")
    return out


def gray_crop_batch(frames: np.ndarray, crop_region, n_threads: int = 4,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, H, W, 3) uint8 BGR -> (N, y2-y1, x2-x1) uint8 grayscale crops,
    bit-equal to cv2.cvtColor + slicing.  The crop must lie inside the
    frame.  `out`, when given, receives the crops (a pinned buffer's view)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native frame pump is not available (g++ or libjpeg missing)")
    frames = np.ascontiguousarray(frames, np.uint8)
    n, H, W, _ = frames.shape
    (x1, y1), (x2, y2) = crop_region
    if not (0 <= y1 < y2 <= H and 0 <= x1 < x2 <= W):
        raise ValueError(f"crop {crop_region} outside a {H} x {W} frame")
    out = _out((n, y2 - y1, x2 - x1), out)
    lib.swt_gray_crop_batch(_u8ptr(frames), n, H, W, y1, y2, x1, x2, _u8ptr(out), n_threads)
    return out


def gray_crop_frames(frames: Sequence[np.ndarray], crop_region, out: np.ndarray,
                     n_threads: int = 4) -> np.ndarray:
    """A list of (H, W, 3) uint8 BGR frames -> their (N, y2-y1, x2-x1)
    gray crops in `out`, each frame cropped where it lies (no stacked copy
    of the BGR crops), the frames split over `n_threads` threads.  The
    crop must lie inside every frame; the result is gray_crop_batch's."""
    lib = _load_gray()
    if lib is None:
        raise RuntimeError("the gray crop library is not available (g++ missing)")
    (x1, y1), (x2, y2) = crop_region
    out = _out((len(frames), y2 - y1, x2 - x1), out)
    # a frame whose pixels are not packed B, G, R in rows is copied so
    keep = [f if f.dtype == np.uint8 and f.ndim == 3 and f.strides[1:] == (3, 1)
            else np.ascontiguousarray(f, np.uint8) for f in frames]
    for f in keep:
        if f.ndim != 3 or f.shape[2] != 3 or not (0 <= y1 < y2 <= f.shape[0]
                                                 and 0 <= x1 < x2 <= f.shape[1]):
            raise ValueError(f"crop {crop_region} outside a {f.shape} frame")
    ptrs = (_U8P * len(keep))(*(_u8ptr(f) for f in keep))
    strides = (_I64 * len(keep))(*(f.strides[0] for f in keep))
    lib.swt_gray_crop_frames(ptrs, strides, len(keep), y1, y2, x1, x2, _u8ptr(out), n_threads)
    return out


def decode_jpeg_bgr(data: bytes, max_h: int = 4320, max_w: int = 7680) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) uint8 BGR, or None on a decode failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native frame pump is not available (g++ or libjpeg missing)")
    buf = np.frombuffer(data, np.uint8)
    # scanlines land at the decoded width's stride: a flat buffer, reshaped
    # by the decoded (h, w)
    out = np.empty(max_h * max_w * 3, np.uint8)
    h, w = _INT(0), _INT(0)
    rc = lib.swt_decode_jpeg_bgr(_u8ptr(buf), buf.size, _u8ptr(out), max_h, max_w,
                                 ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_window_gray(encoded_frames, H: int, W: int, crop_region, n_threads: int = 4,
                       out: Optional[np.ndarray] = None):
    """A window of JPEG buffers of (H, W) frames, decoded straight to gray
    crops: ((N, ch, cw) uint8, ok (N,) bool).  A frame that fails to decode
    is zero and flagged, so the caller can substitute the last good crop
    (the reference's io_video.py:51-53)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native frame pump is not available (g++ or libjpeg missing)")
    bufs = np.frombuffer(
        b"".join(e if isinstance(e, bytes) else bytes(e) for e in encoded_frames), np.uint8)
    offsets = np.zeros(len(encoded_frames) + 1, np.int64)
    np.cumsum([len(e) for e in encoded_frames], out=offsets[1:])
    (x1, y1), (x2, y2) = crop_region
    out = _out((len(encoded_frames), y2 - y1, x2 - x1), out)
    ok = np.zeros(len(encoded_frames), np.uint8)
    lib.swt_decode_window_gray(
        _u8ptr(bufs), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(encoded_frames), H, W, y1, y2, x1, x2, _u8ptr(out), _u8ptr(ok), n_threads)
    return out, ok.astype(bool)


class AVIReader:
    """Sequential decoder of MJPEG-in-AVI over the native container parser.

    Open with AVIReader.open(), which returns None for anything that is not
    an MJPG AVI (or without the library); the caller then takes cv2."""

    def __init__(self, lib, handle, n_frames, fps, width, height):
        self._lib = lib
        self._handle = handle
        self.n_frames = n_frames
        self.fps = fps
        self.width = width
        self.height = height
        # a read must not run while close() frees the handle (a prefetcher
        # thread may be reading when the owner closes the source)
        self._rw_lock = threading.Lock()

    @classmethod
    def open(cls, path) -> Optional["AVIReader"]:
        lib = _load()
        if lib is None:
            return None
        n, fps, w, h = _INT(0), ctypes.c_double(0.0), _INT(0), _INT(0)
        handle = lib.swt_avi_open(str(path).encode(), ctypes.byref(n), ctypes.byref(fps),
                                  ctypes.byref(w), ctypes.byref(h))
        if not handle:
            return None
        return cls(lib, handle, n.value, fps.value, w.value, h.value)

    def read(self) -> Optional[np.ndarray]:
        """The next frame as (H, W, 3) uint8 BGR; None on a decode error
        (the stream advances, as a failed cv2 retrieve does) or at its end."""
        max_h = self.height or 4320
        max_w = self.width or 7680
        out = np.empty(max_h * max_w * 3, np.uint8)
        h, w = _INT(0), _INT(0)
        with self._rw_lock:
            if not self._handle:
                return None
            rc = self._lib.swt_avi_read_bgr(self._handle, _u8ptr(out), max_h, max_w,
                                            ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            return None
        return out[: h.value * w.value * 3].reshape(h.value, w.value, 3)

    def close(self) -> None:
        with self._rw_lock:
            if self._handle:
                self._lib.swt_avi_close(self._handle)
                self._handle = None

    def __del__(self):
        self.close()
