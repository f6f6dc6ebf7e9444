"""Per-video orchestration on one device.

Counterpart of swiftwatcher_tpu/pipeline/runner.py:run_video with the host
tracker: build the ROI mask from the first frame, stream gray window
batches to the device, run the localisation program per batch, step the
host SegmentTracker (scipy) over each frame's centroids, classify
the events and, when asked, write the six CSVs (io/export.py, which
needs pandas).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import pin_numerics
from ..geometry import crop_region_from_corners, roi_crop_region_from_corners
from ..io.prefetch import WindowPrefetcher
from ..io.source import FrameSource
from ..ops.roi_mask import generate_roi_mask
from ..utils.metrics import RunMetrics
from .events import ClassifiedEvents, classify_events, labels_dataframe
from .tracking import Event, SegmentTracker
from .window import localize_windows_gray


@dataclasses.dataclass
class VideoResult:
    events: List[Event]
    classified: Optional[ClassifiedEvents]
    total_predicted: int
    total_rejected: int
    frames_processed: int
    ialm_iters: List[int]
    export_dir: Optional[Path] = None
    metrics: Optional[RunMetrics] = None


def frame_centroids(table, b: int, t: int):
    """(row, col) float64 centroids of frame (b, t) of a host (B, T, 256)
    table, in ascending label order (regionprops parity)."""
    idx = np.nonzero(table.valid[b, t])[0]
    sum_y = table.sum_y[b, t].astype(np.float64)
    sum_x = table.sum_x[b, t].astype(np.float64)
    area = table.area[b, t].astype(np.float64)
    return [(sum_y[k] / area[k], sum_x[k] / area[k]) for k in idx]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md section 1 item {item})")


def run_video(
    source: FrameSource,
    corners,
    cfg: PipelineConfig,
    device: torch.device,
    export_dir: Optional[Path] = None,
    debug: bool = False,
    *,
    status_cb: Optional[Callable[[int, int], None]] = None,
    tracker_impl: str = "host",
    mesh=None,
    segment_filter=None,
    checkpoint_path: Optional[Path] = None,
    profile_dir: Optional[Path] = None,
    export_segments_dir: Optional[Path] = None,
) -> VideoResult:
    """Count swifts in one video on `device`.

    On a CUDA device this pins full-f32 products first (`pin_numerics`).
    status_cb(frames_processed, total_frames) is called after each batch."""
    if tracker_impl != "host":
        _not_ported(f"tracker_impl={tracker_impl!r}", "1, device tracker")
    if mesh is not None:
        _not_ported("mesh", "6, mesh")
    if segment_filter is not None:
        _not_ported("segment_filter", "4, --classify")
    if checkpoint_path is not None:
        _not_ported("checkpoint_path", "2, checkpoint/resume")
    if profile_dir is not None:
        _not_ported("profile_dir", "2, profiling")
    if export_segments_dir is not None:
        _not_ported("export_segments_dir", "4, --classify and --export")
    device = torch.device(device)
    if device.type == "cuda":
        pin_numerics()

    ff = source.read_frame(0, increment=False)
    crop_region = crop_region_from_corners(corners, cfg)
    roi_region = roi_crop_region_from_corners(corners, cfg)
    roi_mask = generate_roi_mask(ff, roi_region, crop_region, cfg, device=device).cpu().numpy()
    tracker = SegmentTracker(roi_mask, cfg)
    metrics = RunMetrics()
    ialm_iters: List[int] = []
    frames_processed = 0

    def consume(pending):
        nonlocal frames_processed
        table, iters, wins = pending
        metrics.stage_start("consume")
        table = table.map(lambda a: a.cpu()).map(torch.Tensor.numpy)
        iters = iters.cpu().numpy()
        for b, (_, numbers, stamps) in enumerate(wins):
            ialm_iters.append(int(iters[b]))
            for t in range(cfg.window_size):
                # Null frames (fn = -1) yield no segments: their RPCA output
                # is null-space noise whose direction is solver-dependent
                # (PARITY deviation 11).  The tracker still steps.
                centroids = [] if numbers[t] < 0 else frame_centroids(table, b, t)
                tracker.step(centroids, numbers[t], stamps[t])
                metrics.segments_total += len(centroids)
                frames_processed += numbers[t] >= 0
            metrics.windows += 1
        metrics.batches += 1
        metrics.frames_processed = frames_processed
        metrics.stage_stop("consume")
        if status_cb is not None:
            status_cb(frames_processed, source.total_frames)

    prefetcher = WindowPrefetcher(source, crop_region, device, cfg)
    try:
        # dispatch batch k+1 before consuming batch k
        pending = None
        while True:
            metrics.stage_start("prefetch_wait")
            batch = prefetcher.next()
            metrics.stage_stop("prefetch_wait")
            nxt = None
            if batch is not None:
                gray, wins, _ = batch
                metrics.stage_start("localize")
                table, iters = localize_windows_gray(gray, cfg)
                metrics.stage_stop("localize")
                nxt = (table, iters, wins)
            if pending is not None:
                consume(pending)
            pending = nxt
            if nxt is None:
                break
    finally:
        prefetcher.close()

    events = tracker.events
    metrics.events = len(events)
    metrics.ialm_iters = ialm_iters
    metrics.read_errors = source.read_errors
    metrics.wire_bytes = prefetcher.bytes_uploaded
    classified = classify_events(events, cfg) if events else None

    out_dir = None
    if classified is not None and export_dir is not None:
        from ..io.export import export_results, generate_test_dir

        out_dir = generate_test_dir(Path(export_dir)) if debug else Path(export_dir)
        export_results(
            out_dir, labels_dataframe(classified, source.fps), source.fps,
            source.start_frame, source.end_frame,
        )
        metrics.write_manifest(out_dir / "run_manifest.json")
    return VideoResult(
        events=events,
        classified=classified,
        total_predicted=classified.total_predicted if classified else 0,
        total_rejected=classified.total_rejected if classified else 0,
        frames_processed=frames_processed,
        ialm_iters=ialm_iters,
        export_dir=out_dir,
        metrics=metrics,
    )
