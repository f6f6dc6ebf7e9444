"""Background window prefetching: read, crop, grayscale and upload ahead.

Counterpart of swiftwatcher_tpu/io/prefetch.py without the wire codec.  A
single worker thread reads up to `batch_windows` windows (the loop
condition is checked before each window, as the reference does), slices
the chimney crop, grays it with numpy into a pinned host buffer and starts
a non-blocking copy to the caller's device.  A partial final batch is
padded by repeating its last window; its outputs are discarded downstream.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..ops.color import bgr_to_gray_host
from .source import FrameSource


class WindowPrefetcher:
    """Yields (gray (B, T, h, w) uint8 on `device`, windows, cursor) batches,
    where windows is a list of (frames, frame_numbers, stamps) per real
    window and cursor is (next_frame_number, frames_planned).  frames is
    the source's list of full-resolution BGR frames when keep_frames is
    set (the classifier and the segment export crop from them), else None."""

    def __init__(
        self,
        source: FrameSource,
        crop_region,
        device: torch.device,
        cfg: PipelineConfig = DEFAULT_CONFIG,
        initial_planned: int = 0,
        keep_frames: bool = False,
    ):
        self.source = source
        self.keep_frames = keep_frames
        self.cfg = cfg
        self.device = torch.device(device)
        (self.x1, self.y1), (self.x2, self.y2) = crop_region
        # frames already counted by a run this one resumes
        self._planned = initial_planned
        self._exhausted = initial_planned >= source.total_frames
        self.bytes_uploaded = 0
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._futures = [
            self._ex.submit(self._produce) for _ in range(cfg.prefetch_depth)
        ]

    def _produce(self):
        if self._exhausted:
            return None
        cfg = self.cfg
        B = max(cfg.batch_windows, 1)
        wins, grays = [], []
        while len(wins) < B and self._planned < self.source.total_frames:
            frames, numbers, stamps = self.source.get_window(cfg.window_size)
            crops = np.stack([f[self.y1 : self.y2, self.x1 : self.x2, :] for f in frames])
            grays.append(bgr_to_gray_host(crops))
            wins.append((frames if self.keep_frames else None, numbers, stamps))
            self._planned += sum(1 for n in numbers if n >= 0)
        if not wins:
            self._exhausted = True
            return None
        pin = self.device.type == "cuda"
        host = torch.empty((B, *grays[0].shape), dtype=torch.uint8, pin_memory=pin)
        view = host.numpy()
        for b in range(B):
            view[b] = grays[min(b, len(grays) - 1)]
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
