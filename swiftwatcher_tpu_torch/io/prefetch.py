"""Background window prefetching: read, crop, grayscale and upload ahead.

Counterpart of swiftwatcher_tpu/io/prefetch.py.  A single worker thread
reads up to `batch_windows` windows (the loop condition is checked before
each window, as the reference does), grays each window's chimney crop into
a pinned host buffer and starts a non-blocking copy to the caller's device.
A partial final batch is padded by repeating its last window; its outputs
are discarded downstream (and repeated frames keep the wire codec's
residuals at zero).

The wire codec (io/wirecodec.py, cfg.wire_codec): "delta4" and "delta6"
encode every batch on the host and ship the packet instead of the raw
crops; "auto" times three round trips of 2 MiB to the device and back and
engages delta6 when the best of them is below cfg.wire_auto_mbps (a card's
host link is far faster, so it ships raw there); anything else ships raw.
A batch whose escapes overflow their cap ships raw.  delta6's level-2 and
level-3 streams are padded to buckets that only grow, as in the JAX
package, so its wire bytes are the JAX package's and the set of shapes
stays small.

A window's gray crops come from one of three paths, all giving the same
bytes:

  * encoded (cfg.native_decode, an HDF5 source of JPEG frames): libjpeg
    decodes each payload straight to its gray crop (io/native.py);
  * gray-crop stream (cfg.av_gray_decode, a container on the av or
    parallel backend where its probes pass): the decoder emits gray crops
    and no full BGR frame (VideoFileSource.enable_gray_crop_stream);
  * frames (the default): the source's BGR frames, each window cropped
    and grayed in threads by csrc/gray_crop.cpp (io/native.py:
    gray_crop_frames, which needs g++ but no libjpeg), else by numpy,
    which also takes a crop past a frame's edge.

The first two need no full frame, so they are off when the caller keeps
the frames (the classifier and the segment export crop from them).

Given the run's metrics (utils/metrics.py), the worker binds them on its
thread and books each batch's reads into the pinned buffer as a
`prefetch_read` span and its upload (or encode and put) as a
`prefetch_upload` span; in frames mode each window's gray crop is a
`prefetch_gray_crop` span inside `prefetch_read`.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..ops.color import bgr_to_gray_host
from ..utils.metrics import RunMetrics, bind, span
from . import native
from .source import FrameSource
from .wirecodec import device_put_packet, device_put_packet6, encode_delta4, encode_delta6

PROBE_BYTES = 2 * 1024 * 1024


def link_rate(device: torch.device, probes: int = 3) -> float:
    """Bytes/s of the best of `probes` round trips of PROBE_BYTES to `device`
    and back (both directions' bytes over the elapsed time)."""
    probe = torch.zeros(PROBE_BYTES, dtype=torch.uint8)
    best = float("inf")
    for _ in range(probes):
        t0 = time.perf_counter()
        probe.to(device).cpu()
        best = min(best, time.perf_counter() - t0)
    return 2 * PROBE_BYTES / max(best, 1e-9)


def _round_up(n: int, quantum: int) -> int:
    return -(-max(n, 1) // quantum) * quantum


class WindowPrefetcher:
    """Yields (payload, windows, cursor) batches.  payload is the gray
    (B, T, h, w) uint8 batch on `device`, or the wire codec's packet of its
    (B*T, h, w) frames, uploaded (io/wirecodec.py: WirePacket for delta4,
    WirePacket6 for delta6).  windows is a list of (frames, frame_numbers,
    stamps) per real window and cursor is (next_frame_number,
    frames_planned).  frames is the source's list of full-resolution BGR
    frames when keep_frames is set (the classifier and the segment export
    crop from them), else None.  frame_hw is the source's (H, W) where the
    caller knows it (the encoded path needs it; it probes one decode
    otherwise).  `mode` tells which path serves the windows: "encoded",
    "gray_stream" or "frames".  `codec` is the wire codec engaged (None for
    raw), `link_bytes_per_s` the rate `auto` measured (None unless auto),
    `bytes_uploaded` the bytes shipped and `batches_by_format` the batches
    shipped as "raw", "delta4" and "delta6".  `metrics`, when given, is the
    run the worker's spans book into."""

    def __init__(
        self,
        source: FrameSource,
        crop_region,
        device: torch.device,
        cfg: PipelineConfig = DEFAULT_CONFIG,
        initial_planned: int = 0,
        keep_frames: bool = False,
        frame_hw: Optional[Tuple[int, int]] = None,
        metrics: Optional[RunMetrics] = None,
    ):
        self.source = source
        self.metrics = metrics
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
        self._gray_crop = self.mode == "frames" and native.has_symbol("swt_gray_crop_frames")
        self.codec = cfg.wire_codec if cfg.wire_codec in ("delta4", "delta6") else None
        self.link_bytes_per_s = None
        if cfg.wire_codec == "auto":
            self.link_bytes_per_s = link_rate(self.device)
            if self.link_bytes_per_s < cfg.wire_auto_mbps * 1e6:
                self.codec = "delta6"
        self._lvl2_bucket = 0
        self._esc3_bucket = 0
        self.bytes_uploaded = 0
        self.batches_by_format = {"raw": 0, "delta4": 0, "delta6": 0}
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
        with span("prefetch_gray_crop"):
            if self._gray_crop and all(
                    0 <= self.y1 < self.y2 <= f.shape[0] and 0 <= self.x1 < self.x2 <= f.shape[1]
                    for f in frames):
                if out is None:
                    out = np.empty((len(frames), self.y2 - self.y1, self.x2 - self.x1),
                                   np.uint8)
                gray = native.gray_crop_frames(frames, self.crop_region, out)
            else:
                # python-slice semantics for a crop past the frame's edge
                gray = bgr_to_gray_host(
                    np.stack([f[self.y1 : self.y2, self.x1 : self.x2, :] for f in frames]))
                if out is not None:
                    out[...] = gray
        return (frames if self.keep_frames else None), numbers, stamps, gray

    def _produce(self):
        with bind(self.metrics):
            return self._produce_batch()

    def _produce_batch(self):
        if self._exhausted:
            return None
        cfg = self.cfg
        B = max(cfg.batch_windows, 1)
        pin = self.device.type == "cuda"
        host = view = None
        wins = []
        with span("prefetch_read"):
            while len(wins) < B and self._planned < self.source.total_frames:
                if self.mode == "frames":
                    frames, numbers, stamps, gray = self._frames_window(
                        None if view is None else view[len(wins)])
                else:
                    # the crop's shape is the region's: both paths need it
                    # inside the frame
                    if view is None:
                        host = torch.empty((B, cfg.window_size, self.y2 - self.y1,
                                            self.x2 - self.x1), dtype=torch.uint8,
                                           pin_memory=pin)
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
        with span("prefetch_upload"):
            payload = self._encode(view) if self.codec is not None else None
            if payload is None:
                payload = host.to(self.device, non_blocking=pin)
                self.bytes_uploaded += host.numel()
                self.batches_by_format["raw"] += 1
        if self._planned >= self.source.total_frames:
            self._exhausted = True
        return payload, wins, (self.source.next_frame_number, self._planned)

    def _encode(self, gray: np.ndarray):
        """The uploaded packet of the (B, T, h, w) batch in the engaged
        format, or None when its escapes overflow (the batch ships raw)."""
        cfg = self.cfg
        h, w = gray.shape[2:]
        frames = gray.reshape(-1, h, w)
        if self.codec == "delta6":
            pkt = encode_delta6(frames, cfg.wire_escape_cap)
            if pkt is not None:
                # quanta shrink for small batches, so that padding never
                # swamps a small crop's bytes
                q2 = min(cfg.wire_lvl2_quantum, max(1024, gray.size // 64))
                q3 = min(cfg.wire_esc3_quantum, max(128, gray.size // 2048))
                self._lvl2_bucket = max(self._lvl2_bucket, _round_up(pkt.lvl2.size, q2))
                if pkt.lvl2.size < self._lvl2_bucket:
                    pkt.lvl2 = np.pad(pkt.lvl2, (0, self._lvl2_bucket - pkt.lvl2.size))
                n3 = int(np.count_nonzero(pkt.esc_idx < gray.size))
                self._esc3_bucket = max(self._esc3_bucket, _round_up(n3, q3))
                if self._esc3_bucket < pkt.esc_idx.size:
                    pkt.esc_idx = pkt.esc_idx[: self._esc3_bucket].copy()
                    pkt.esc_val = pkt.esc_val[: self._esc3_bucket].copy()
        else:
            # the escape cap scales with the batch (1/16 of its residuals,
            # at least 1024) up to cfg.wire_escape_cap
            cap = min(cfg.wire_escape_cap, max(1024, (gray.size - h * w) // 16))
            pkt = encode_delta4(frames, cap)
        if pkt is None:
            return None
        put = device_put_packet6 if self.codec == "delta6" else device_put_packet
        payload = put(pkt, self.device)
        self.bytes_uploaded += payload.nbytes
        self.batches_by_format[self.codec] += 1
        return payload

    def next(self):
        """The next ready batch (None when the video is done)."""
        fut = self._futures.pop(0)
        self._futures.append(self._ex.submit(self._produce))
        return fut.result()

    def close(self):
        # wait=True: an in-flight read must finish before the caller drops
        # the source
        self._ex.shutdown(wait=True, cancel_futures=True)
