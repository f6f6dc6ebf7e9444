"""Per-video orchestration on one device.

Counterpart of swiftwatcher_tpu/pipeline/runner.py:run_video: build the ROI
mask from the first frame, stream gray window batches to the device, run
the localisation program per batch, track, classify the events and, when
asked, write the six CSVs (io/export.py, which needs pandas).

Two trackers, as in the JAX package:
  * "host" (the default of run_video): read each batch's region tables
    back and step the host SegmentTracker (scipy) frame by frame;
  * "device" (the CLI's default): compact the tables to max_tracks slots
    on the device and run the whole batch's tracking scan there
    (pipeline/tracking_device.py, one kernel launch on a card); only the
    event buffer, the overflow flags and the IALM iteration counts are
    read back.
Either can checkpoint every `checkpoint_interval_batches` batches and
resume from its checkpoint (utils/checkpoint.py).
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
from ..utils import checkpoint
from ..utils.metrics import RunMetrics
from .events import ClassifiedEvents, classify_events, labels_dataframe
from .tracking import Event, SegmentTracker
from .tracking_device import compact_tables, empty_state, track_window
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
    checkpoint_interval_batches: int = 16,
    profile_dir: Optional[Path] = None,
    export_segments_dir: Optional[Path] = None,
) -> VideoResult:
    """Count swifts in one video on `device`.

    On a CUDA device this pins full-f32 products first (`pin_numerics`).
    status_cb(frames_processed, total_frames) is called after each batch.
    tracker_impl: "host" or "device" (see the module docstring).
    checkpoint_path: when set, the tracker state and the frame cursor are
    written there every checkpoint_interval_batches batches, and a
    checkpoint already there resumes the run (the source must support
    seeking)."""
    if tracker_impl not in ("host", "device"):
        raise ValueError(f"tracker_impl must be 'host' or 'device', got {tracker_impl!r}")
    if mesh is not None:
        _not_ported("mesh", "6, mesh")
    if segment_filter is not None:
        _not_ported("segment_filter", "4, --classify")
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
    roi_dev = generate_roi_mask(ff, roi_region, crop_region, cfg, device=device)
    tracker = SegmentTracker(roi_dev.cpu().numpy(), cfg)
    metrics = RunMetrics()
    ialm_iters: List[int] = []
    frames_processed = 0
    use_device_tracker = tracker_impl == "device"
    if use_device_tracker and not getattr(source, "uniform_timestamps", True):
        raise ValueError(
            "the device tracker stamps events by frame number; this source "
            "declares non-uniform timestamps, use tracker_impl='host'"
        )
    dev_state = empty_state(cfg.max_tracks, device) if use_device_tracker else None

    if checkpoint_path is not None:
        src_info = checkpoint.source_fingerprint(source)
        if use_device_tracker:
            restored = checkpoint.load_checkpoint_device(checkpoint_path, src_info, device)
        else:
            restored = checkpoint.load_checkpoint(checkpoint_path, tracker, src_info)
        if restored is not None:
            if not source.supports_seek:
                raise ValueError(
                    "cannot resume a sequential source (cv2.VideoCapture reads in "
                    "order and ignores frame numbers); re-encode to .npy for "
                    "checkpointed runs"
                )
            if use_device_tracker:
                source.next_frame_number, frames_processed, dev_state, prior = restored
                tracker.events.extend(prior)
            else:
                source.next_frame_number, frames_processed = restored

    def track_on_device(table, wins):
        """One track_window launch over the batch's compacted tables:
        (event buffer, (B, T) overflow flags, the state after the batch)."""
        nonlocal dev_state
        B, T = table.valid.shape[:2]
        cy, cx, kvalid, overflow = compact_tables(table, cfg.max_tracks)
        fns = torch.from_numpy(np.concatenate(
            [np.asarray(w[1], np.int32) for w in wins]
            + [np.full(T, -1, np.int32)] * (B - len(wins))))
        # a pinned copy does not make the host wait for the stream
        pin = device.type == "cuda"
        fns = (fns.pin_memory() if pin else fns).to(device, non_blocking=pin)
        # batch-padding windows are no-op frames
        active = torch.arange(B * T, device=device) < len(wins) * T
        # null frames and batch padding (fn = -1) carry no segments, as on
        # the host path, and so no overflow
        real = (fns >= 0).reshape(B, T)
        kvalid = kvalid & real[..., None]
        overflow = overflow & real
        dev_state, events = track_window(
            dev_state, roi_dev, cy.reshape(B * T, -1), cx.reshape(B * T, -1),
            kvalid.reshape(B * T, -1), fns, cfg, active=active,
        )
        # the state is kept with the batch, so that a checkpoint written when
        # the batch is consumed pairs it with the batch's cursor
        return events, overflow, dev_state

    def drain_device_events(events, overflow) -> None:
        """Read back one batch's event buffer and append its events.  The
        scan carries frame numbers only; the port's stamp of a frame is its
        frame number, so the events equal the host tracker's."""
        ev = events.to_numpy()
        metrics.track_overflows += int(overflow.sum())
        if ev["overflow"]:
            raise RuntimeError("device tracker event buffer overflow")
        for i in range(int(ev["count"])):
            fn = int(ev["last_fn"][i])
            tracker.events.append(Event(
                first_centroid=(float(ev["first_cy"][i]), float(ev["first_cx"][i])),
                last_centroid=(float(ev["last_cy"][i]), float(ev["last_cx"][i])),
                frame_number=fn,
                timestamp=fn,
            ))

    def consume(pending):
        nonlocal frames_processed
        table, iters, wins, cursor, on_device = pending
        metrics.stage_start("consume")
        iters = iters.cpu().numpy()
        if on_device is not None:
            events, overflow, state_after = on_device
            drain_device_events(events, overflow.cpu().numpy())
            for b, (_, numbers, _) in enumerate(wins):
                ialm_iters.append(int(iters[b]))
                frames_processed += sum(1 for n in numbers if n >= 0)
                metrics.windows += 1
        else:
            table = table.map(lambda a: a.cpu()).map(torch.Tensor.numpy)
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
        if checkpoint_path is not None and metrics.batches % checkpoint_interval_batches == 0:
            src_info = checkpoint.source_fingerprint(source)
            if on_device is not None:
                checkpoint.save_checkpoint_device(
                    checkpoint_path, cursor[0], frames_processed, state_after,
                    tracker.events, source.fps, source_info=src_info)
            else:
                checkpoint.save_checkpoint(
                    checkpoint_path, cursor[0], frames_processed, tracker, source.fps,
                    source_info=src_info)
        metrics.stage_stop("consume")
        if status_cb is not None:
            status_cb(frames_processed, source.total_frames)

    prefetcher = WindowPrefetcher(source, crop_region, device, cfg,
                                  initial_planned=frames_processed)
    try:
        # dispatch batch k+1 before consuming batch k
        pending = None
        while True:
            metrics.stage_start("prefetch_wait")
            batch = prefetcher.next()
            metrics.stage_stop("prefetch_wait")
            nxt = None
            if batch is not None:
                gray, wins, cursor = batch
                metrics.stage_start("localize")
                table, iters = localize_windows_gray(gray, cfg)
                metrics.stage_stop("localize")
                on_device = None
                if use_device_tracker:
                    metrics.stage_start("track_dispatch")
                    on_device = track_on_device(table, wins)
                    metrics.stage_stop("track_dispatch")
                nxt = (table, iters, wins, cursor, on_device)
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
