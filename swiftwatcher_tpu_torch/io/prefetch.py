"""Background window prefetching: read, crop, grayscale and upload ahead.

Counterpart of swiftwatcher_tpu/io/prefetch.py without the wire codec.  A
single worker thread reads up to `batch_windows` windows (the loop
condition is checked before each window, as the reference does), grays
each window's chimney crop into a pinned host buffer and starts a
non-blocking copy to the caller's device.  A partial final batch is padded
by repeating its last window; its outputs are discarded downstream.

A window's gray crops come from one of three paths, all giving the same
bytes:

  * encoded (cfg.native_decode, an HDF5 source of JPEG frames): libjpeg
    decodes each payload straight to its gray crop (io/native.py);
  * gray-crop stream (cfg.av_gray_decode, a container on the av or
    parallel backend where its probes pass): the decoder emits gray crops
    and no full BGR frame (VideoFileSource.enable_gray_crop_stream);
  * default: the source's BGR frames, cropped and grayed by the native
    frame pump where it is built, else by numpy.

The first two need no full frame, so they are off when the caller keeps
the frames (the classifier and the segment export crop from them).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..ops.color import bgr_to_gray_host
from . import native
from .source import FrameSource


class WindowPrefetcher:
    """Yields (gray (B, T, h, w) uint8 on `device`, windows, cursor) batches,
    where windows is a list of (frames, frame_numbers, stamps) per real
    window and cursor is (next_frame_number, frames_planned).  frames is
    the source's list of full-resolution BGR frames when keep_frames is
    set (the classifier and the segment export crop from them), else None.
    frame_hw is the source's (H, W) where the caller knows it (the encoded
    path needs it; it probes one decode otherwise).  `mode` tells which
    path serves the windows: "encoded", "gray_stream" or "frames"."""

    def __init__(
        self,
        source: FrameSource,
        crop_region,
        device: torch.device,
        cfg: PipelineConfig = DEFAULT_CONFIG,
        initial_planned: int = 0,
        keep_frames: bool = False,
        frame_hw: Optional[Tuple[int, int]] = None,
    ):
        self.source = source
        self.keep_frames = keep_frames
        self.cfg = cfg
        self.device = torch.device(device)
        self.crop_region = crop_region
        (self.x1, self.y1), (self.x2, self.y2) = crop_region
        # frames already counted by a run this one resumes
        self._planned = initial_planned
        self._exhausted = initial_planned >= source.total_frames
        self._native = native.is_available()
        self._frame_hw = frame_hw
        self._last_good_crop = None
        self.mode = "frames"
        if self._encoded_mode_engages():
            self.mode = "encoded"
        elif (cfg.av_gray_decode and not keep_frames
              and hasattr(source, "enable_gray_crop_stream")
              and source.enable_gray_crop_stream(crop_region)):
            self.mode = "gray_stream"
        self.bytes_uploaded = 0
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._futures = [
            self._ex.submit(self._produce) for _ in range(cfg.prefetch_depth)
        ]

    def _encoded_mode_engages(self) -> bool:
        """The JPEG-to-gray-crop decode of an HDF5 source: asked for by
        cfg.native_decode, with the frame pump built, a JPEG first payload
        (a cache of PNGs takes cv2's path), a known frame size and a crop
        inside the frame (an out-of-bounds crop needs python-slice
        semantics)."""
        src = self.source
        if not (self.cfg.native_decode and not self.keep_frames and self._native
                and hasattr(src, "get_encoded_window")):
            return False
        head = src.peek_encoded(src.start_frame)
        if head is None or not head.startswith(b"\xff\xd8"):
            return False
        if self._frame_hw is None:
            first = src.read_frame(src.start_frame, increment=False)
            if first is None:
                return False
            self._frame_hw = first.shape[:2]
        H, W = self._frame_hw
        return 0 <= self.y1 < self.y2 <= H and 0 <= self.x1 < self.x2 <= W

    def _encoded_window(self, out: np.ndarray):
        bufs, numbers, stamps = self.source.get_encoded_window(self.cfg.window_size)
        H, W = self._frame_hw
        _, ok = native.decode_window_gray(
            [b if b is not None else b"" for b in bufs], H, W, self.crop_region, out=out)
        # the reference's fallback (io_video.py:51-53): a frame that fails to
        # decode takes the last good crop and counts an error; null frames
        # stay zero
        for i, n in enumerate(numbers):
            if n < 0:
                continue
            if ok[i]:
                self._last_good_crop = out[i].copy()
            else:
                self.source.read_errors += 1
                if self._last_good_crop is not None:
                    out[i] = self._last_good_crop
        return None, numbers, stamps

    def _frames_window(self, out: Optional[np.ndarray]):
        frames, numbers, stamps = self.source.get_window(self.cfg.window_size)
        if self._native and all(
                0 <= self.y1 < self.y2 <= f.shape[0] and 0 <= self.x1 < self.x2 <= f.shape[1]
                for f in frames):
            if out is None:
                out = np.empty((len(frames), self.y2 - self.y1, self.x2 - self.x1), np.uint8)
            gray = native.gray_crop_frames(frames, self.crop_region, out)
        else:
            # python-slice semantics for a crop past the frame's edge
            gray = bgr_to_gray_host(
                np.stack([f[self.y1 : self.y2, self.x1 : self.x2, :] for f in frames]))
            if out is not None:
                out[...] = gray
        return (frames if self.keep_frames else None), numbers, stamps, gray

    def _produce(self):
        if self._exhausted:
            return None
        cfg = self.cfg
        B = max(cfg.batch_windows, 1)
        pin = self.device.type == "cuda"
        host = view = None
        wins = []
        while len(wins) < B and self._planned < self.source.total_frames:
            if self.mode == "frames":
                frames, numbers, stamps, gray = self._frames_window(
                    None if view is None else view[len(wins)])
            else:
                # the crop's shape is the region's: both paths need it inside
                # the frame
                if view is None:
                    host = torch.empty((B, cfg.window_size, self.y2 - self.y1,
                                        self.x2 - self.x1), dtype=torch.uint8, pin_memory=pin)
                    view = host.numpy()
                if self.mode == "encoded":
                    frames, numbers, stamps = self._encoded_window(view[len(wins)])
                else:
                    _, numbers, stamps = self.source.get_gray_crop_window(
                        cfg.window_size, out=view[len(wins)])
                    frames = None
            if view is None:
                # the first window of a frames batch fixes the crop's shape
                host = torch.empty((B, *gray.shape), dtype=torch.uint8, pin_memory=pin)
                view = host.numpy()
                view[0] = gray
            wins.append((frames, numbers, stamps))
            self._planned += sum(1 for n in numbers if n >= 0)
        if not wins:
            self._exhausted = True
            return None
        view[len(wins):] = view[len(wins) - 1]
        gray = host.to(self.device, non_blocking=pin)
        self.bytes_uploaded += host.numel()
        if self._planned >= self.source.total_frames:
            self._exhausted = True
        return gray, wins, (self.source.next_frame_number, self._planned)

    def next(self):
        """The next ready batch (None when the video is done)."""
        fut = self._futures.pop(0)
        self._futures.append(self._ex.submit(self._produce))
        return fut.result()

    def close(self):
        # wait=True: an in-flight read must finish before the caller drops
        # the source
        self._ex.shutdown(wait=True, cancel_futures=True)
