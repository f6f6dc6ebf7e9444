"""Per-video orchestration on one device.

Counterpart of swiftwatcher_tpu/pipeline/runner.py:run_video: build the ROI
mask from the first frame, stream gray window batches to the device, run
the localisation program per batch, track, classify the events and, when
asked, write the six CSVs (io/export.py, which needs pandas).  Under
cfg.wire_codec a batch arrives as a wire codec packet (io/prefetch.py,
io/wirecodec.py), decoded on the device before localisation, and
metrics.wire_bytes counts the bytes shipped.

Two trackers, as in the JAX package:
  * "host" (the default of run_video): read each batch's region tables
    back and step the host SegmentTracker (scipy) frame by frame;
  * "device" (the CLI's default): compact the tables to max_tracks slots
    on the device and run the whole batch's tracking scan there
    (pipeline/tracking_device.py, one kernel launch on a card); only the
    event buffer, the overflow flags and the IALM iteration counts are
    read back.
Either can checkpoint every `checkpoint_interval_batches` batches and
resume from its checkpoint (utils/checkpoint.py).  With a `mesh`
(parallel/mesh.py) each batch's localisation is sharded over the mesh's
ranks, windows over 'data' and pixels over 'model'; this process (rank 0)
keeps the source, stabilisation, the tracker, the classifier and the
CSVs, as the JAX package's mesh mode does.  `profile_dir` records a
torch.profiler trace of the run (the host always, the card's kernels on a
card) and each batch's device time of localisation and of the tracking
scan.

`segment_filter` (--classify, models/classifier.py) drops the segments a
classifier rejects before tracking; it needs the full-resolution frames
(the prefetcher keeps them) and the tables' bboxes.  On the host tracker
one batch_call classifies a batch's segments (a filter without batch_call
is called per frame).  On the device tracker the compacted valid and bbox
planes are read back and the crops are packed on the host; then either
the forward, the keep scatter and the tracking scan are queued on the
device together (pipeline/classify_fused.py), and the next batch's crops
are packed while the card runs them, or, for a crop too large for
a device canvas, with classify_fused=False, with --export or for a filter
without batch_call, the host's keep-mask is uploaded before the scan.
`export_segments_dir` (--export, io/segments_export.py) writes each
frame's segment PNGs after the filter, on either tracker; the device
tracker exports from the same read-back planes, so a frame whose segments
overflow max_tracks exports (and classifies) the first max_tracks of them,
the ones it tracks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import pin_numerics
from ..geometry import crop_array, crop_region_from_corners, roi_crop_region_from_corners
from ..io.prefetch import WindowPrefetcher
from ..io.segments_export import export_frame_segments
from ..io.source import FrameSource
from ..io.wirecodec import WirePacket, WirePacket6, decode_packet
from ..models.classifier import upload
from ..ops.color import bgr_to_gray_host
from ..ops.roi_mask import generate_roi_mask
from ..ops.stabilize import stabilize_window
from ..parallel.mesh import sharded_localize_windows_gray
from ..utils import checkpoint
from ..utils.metrics import RunMetrics, bind, trace_range
from .classify_fused import classify_track_fused, pack_fused
from .events import ClassifiedEvents, classify_events, labels_dataframe
from .tracking import Event, SegmentTracker
from .tracking_device import compact_tables, empty_state, track_window
from .window import localize_windows_gray, localize_windows_packed, localize_windows_packed6


# The profiler's session is process-wide: a second one started beside it
# loses its trace.  The run that holds this lock traces.
_TRACE_LOCK = threading.Lock()


def _start_trace(device: torch.device):
    """A started torch.profiler session (the host; the card's kernels too on
    a card), or None, with a warning, while another run of this process
    traces (run_videos under --profile): that run goes untraced, as the
    JAX package's does where its start_trace fails."""
    if not _TRACE_LOCK.acquire(blocking=False):
        warnings.warn("torch.profiler trace unavailable: another run in this process "
                      "is tracing", RuntimeWarning)
        return None
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    except BaseException:
        _TRACE_LOCK.release()
        raise
    return profiler


def _stop_trace(profiler, profile_dir: Path) -> None:
    try:
        profiler.stop()
        profiler.export_chrome_trace(str(profile_dir / "trace.json"))
    finally:
        _TRACE_LOCK.release()


@dataclasses.dataclass
class _CompactTableView:
    """A RegionTable look-alike over compacted (B, T, K) host arrays.

    The device tracker's classify path hands it to the filter instead of
    the 256-slot table: valid slots are packed first in ascending label
    order (tracking_device.compact_tables), so lookups by
    np.nonzero(valid) see the same segments in the same order."""

    valid: np.ndarray
    min_y: np.ndarray
    min_x: np.ndarray
    max_y: np.ndarray
    max_x: np.ndarray


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


def _start_readback(t: torch.Tensor):
    """Start copying `t` to the host without waiting for it: (host tensor,
    CUDA event to wait on, or None off the card)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_readback(started) -> np.ndarray:
    host, done = started
    if done is not None:
        done.synchronize()
    return host.numpy()


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
    mesh: a parallel.mesh.Mesh whose rank 0 runs on `device`; each batch's
    localisation runs sharded over it (cfg.batch_windows must divide over
    its 'data' axis).  The events equal the unsharded run's.
    segment_filter: optional keep-mask hook (models.classifier.
    SqueezeNetSegmentFilter), called as segment_filter(table, (b, t),
    full_frame_bgr, crop_region) -> list[bool] over the frame's valid
    segments in label order, or through its batch_call(table, {(b, t):
    frame}, crop_region, timers=None) -> {(b, t): list[bool]} when it has
    one; timers is a dict of stage seconds it may add to.  The table has
    at least valid, min_y, min_x, max_y and max_x.
    export_segments_dir: when set (--export), each frame's segment overlay
    and crop PNGs are written there.
    checkpoint_path: when set, the tracker state and the frame cursor are
    written there every checkpoint_interval_batches batches, and a
    checkpoint already there resumes the run (the source must support
    seeking).
    profile_dir: when set, a torch.profiler trace of the run is written
    there as trace.json (Chrome trace format: chrome://tracing or
    Perfetto), with the host's stages as ranges named as the JAX
    package's annotations (localize_dispatch, track_dispatch, consume,
    classify_pack, classify_track_fused, classify), the run's other spans
    (prefetch_wait, stabilize, ialm_solve, classify_forward and each
    blocking read's sync. span; utils/metrics.py) and the kernels' C
    launchers by their entry names.  Each batch's localisation and
    tracking scan are also timed on the device and waited for, into the
    manifest's device_stage_seconds ("localize", "track_scan"); so the
    stages no longer overlap, and frames/s drop while profiling.  The
    manifest goes to profile_dir when there is no export_dir.  One run of
    a process traces at a time: a run that starts while another traces
    warns and writes no trace.json, but still its device stage times."""
    if tracker_impl not in ("host", "device"):
        raise ValueError(f"tracker_impl must be 'host' or 'device', got {tracker_impl!r}")
    batchable = segment_filter is not None and hasattr(segment_filter, "batch_call")
    device = torch.device(device)
    if mesh is not None:
        if cfg.batch_windows % mesh.shape["data"] != 0:
            raise ValueError(
                f"batch_windows={cfg.batch_windows} must divide over the "
                f"mesh 'data' axis ({mesh.shape['data']})"
            )
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh.device != device:
            raise ValueError(f"the mesh's rank 0 runs on {mesh.device}, not on {device}")
    if device.type == "cuda":
        pin_numerics()

    ff = source.read_frame(0, increment=False)
    crop_region = crop_region_from_corners(corners, cfg)
    roi_region = roi_crop_region_from_corners(corners, cfg)
    roi_dev = generate_roi_mask(ff, roi_region, crop_region, cfg, device=device)
    tracker = SegmentTracker(roi_dev.cpu().numpy(), cfg)
    metrics = RunMetrics()
    # stabilisation (opt-in) aligns every window to the pose of the frame
    # the ROI mask was built from, so the mask and all centroids share it
    stab_ref = None
    if cfg.stabilize_max_shift > 0:
        stab_ref = torch.from_numpy(
            bgr_to_gray_host(crop_array(np.asarray(ff), crop_region))).to(device)
    profiling = profile_dir is not None
    if profiling:
        profile_dir = Path(profile_dir)
        profile_dir.mkdir(parents=True, exist_ok=True)
    @contextlib.contextmanager
    def device_stage(stage: str):
        """While profiling, add the stage's device time to the manifest's
        device_stage_seconds: on a card, the span between CUDA events
        recorded on the stream around the stage's work, read once the work
        has finished (so stages do not overlap while profiling); on the
        CPU, where ops run as they are called, the stage's wall time."""
        if not profiling:
            yield
            return
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
            yield
            stop.record(stream)
            stop.synchronize()
            metrics.device_stage_add(stage, start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            yield
            metrics.device_stage_add(stage, time.perf_counter() - t0)
    ialm_iters: List[int] = []
    frames_processed = 0
    use_device_tracker = tracker_impl == "device"
    if use_device_tracker and not getattr(source, "uniform_timestamps", True):
        raise ValueError(
            "the device tracker stamps events by frame number; this source "
            "declares non-uniform timestamps, use tracker_impl='host'"
        )
    dev_state = empty_state(cfg.max_tracks, device) if use_device_tracker else None
    needs_frames = segment_filter is not None or export_segments_dir is not None
    # the fused classify path reads a batch's events back one batch late,
    # so its device work overlaps the next batch's host work
    deferred = [None]

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
        (event buffer, (B, T) overflow flags, the state after the batch,
        None).  With a segment filter or the export the scan waits for
        consume, and this returns ["frames", the scan's inputs, the started
        read-back of the compacted valid and bbox planes, None], the None
        for the batch's host half (frames_host_half) once made."""
        nonlocal dev_state
        B, T = table.valid.shape[:2]
        compacted = compact_tables(table, cfg.max_tracks, with_bbox=needs_frames)
        cy, cx, kvalid, overflow = compacted[:4]
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
        if needs_frames:
            planes = torch.stack((kvalid.to(torch.int32),) + compacted[4])
            return ["frames", cy, cx, kvalid, overflow, fns, active,
                    _start_readback(planes), None]
        with device_stage("track_scan"):
            dev_state, events = track_window(
                dev_state, roi_dev, cy.reshape(B * T, -1), cx.reshape(B * T, -1),
                kvalid.reshape(B * T, -1), fns, cfg, active=active,
            )
        # the state is kept with the batch, so that a checkpoint written when
        # the batch is consumed pairs it with the batch's cursor
        return events, overflow, dev_state, None

    def frames_host_half(wins, readback):
        """The host half of one batch with frames kept: (its compacted
        tables read back, {(b, t): frame} of the frames with a valid slot,
        the fused path's packed crops or None)."""
        with metrics.span("classify_readback"):
            planes = _finish_readback(readback)
        view = _CompactTableView(planes[0].astype(bool), *planes[1:])
        T = view.valid.shape[1]
        frames_by_bt = {(b, t): wins[b][0][t] for b in range(len(wins)) for t in range(T)
                        if view.valid[b, t].any()}
        fused = None
        # the export needs the keep-mask on the host, which the fused path
        # never reads back
        if (export_segments_dir is None and cfg.classify_fused and frames_by_bt
                and getattr(segment_filter, "supports_fused", False)):
            with trace_range("classify_pack"):
                fused = pack_fused(segment_filter, view, frames_by_bt, crop_region,
                                   timers=metrics.stage_seconds)
        return view, frames_by_bt, fused

    def frames_on_device(wins, cy, cx, kvalid, overflow, fns, active, readback, host_half):
        """The keep-mask, the export and the tracking scan of one batch on
        the device tracker: (event buffer, overflow flags, state after,
        n_kept or None), n_kept being the fused path's kept count on the
        device.  host_half: frames_host_half's result, if consume made it
        ahead."""
        nonlocal dev_state
        view, frames_by_bt, fused = host_half or frames_host_half(wins, readback)
        B, T, K = view.valid.shape
        if fused is not None:
            canv, meta, mx = fused
            coeff = segment_filter._coeff_table(mx)
            with metrics.span("classify_device", trace_name="classify_track_fused"):
                dev_state, events, n_kept = classify_track_fused(
                    segment_filter.params, coeff, canv, meta, dev_state, roi_dev,
                    cy, cx, kvalid, fns, active, cfg)
            return events, overflow, dev_state, n_kept
        keep_masks = {}
        if segment_filter is not None and frames_by_bt:
            with trace_range("classify"):
                if batchable:
                    keep_masks = segment_filter.batch_call(view, frames_by_bt, crop_region,
                                                           timers=metrics.stage_seconds)
                else:
                    keep_masks = {key: segment_filter(view, key, frame, crop_region)
                                  for key, frame in frames_by_bt.items()}
            keep = np.ones((B, T, K), bool)
            for (b, t), kl in keep_masks.items():
                metrics.segments_total += sum(1 for k in kl if k)
                keep[b, t, : len(kl[:K])] = kl[:K]
            kvalid = kvalid & upload([keep], device)[0]
        if export_segments_dir is not None:
            for b, (frames, numbers, _) in enumerate(wins):
                for t in range(T):
                    if numbers[t] < 0:
                        continue
                    # the compacted slots hold labels 1..N at 0..N-1, so an
                    # all-true mask gives the PNGs the host tracker's names
                    keep = (keep_masks.get((b, t), []) if segment_filter is not None
                            else [True] * int(view.valid[b, t].sum()))
                    export_frame_segments(
                        frames[t], view, (b, t), numbers[t], crop_region,
                        export_segments_dir, Path(source.filepath).stem, cfg, keep=keep)
        # the unfused path, and a batch without segments, track here
        with metrics.span("track_dispatch"):
            dev_state, events = track_window(
                dev_state, roi_dev, cy.reshape(B * T, K), cx.reshape(B * T, K),
                kvalid.reshape(B * T, K), fns, cfg, active=active)
        return events, overflow, dev_state, None

    def drain_device_events(events, overflow, n_kept=None) -> None:
        """Read back one batch's event buffer and append its events.  The
        scan carries frame numbers only; the port's stamp of a frame is its
        frame number, so the events equal the host tracker's."""
        with metrics.span("sync.consume_events"):
            ev = events.to_numpy()
            metrics.track_overflows += int(overflow.sum())
        if n_kept is not None:
            metrics.segments_total += int(n_kept)
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

    def consume(pending, nxt):
        nonlocal frames_processed
        table, iters, wins, cursor, on_device = pending
        with metrics.span("sync.consume_iters"):
            iters = iters.cpu().numpy()
        if on_device is not None:
            if on_device[0] == "frames":
                on_device = frames_on_device(wins, *on_device[1:])
                if nxt is not None and nxt[4] is not None:
                    # the next batch's host half while the card classifies
                    # this one: its tables were read back before this
                    # batch's IALM counts
                    nxt[4][-1] = frames_host_half(nxt[2], nxt[4][-2])
            events, overflow, state_after, n_kept = on_device
            # a deferred batch is the one before this: drain it first, so
            # that events stay in order
            if deferred[0] is not None:
                drain_device_events(*deferred[0])
                deferred[0] = None
            if n_kept is not None:
                deferred[0] = (events, overflow, n_kept)
            else:
                drain_device_events(events, overflow)
            for b, (_, numbers, _) in enumerate(wins):
                ialm_iters.append(int(iters[b]))
                frames_processed += sum(1 for n in numbers if n >= 0)
                metrics.windows += 1
        else:
            table = table.map(lambda a: a.cpu()).map(torch.Tensor.numpy)
            keep_masks = None
            if batchable:
                # null frames carry no segments (below), so they go unclassified
                frames_by_bt = {(b, t): frames[t] for b, (frames, numbers, _) in enumerate(wins)
                                for t in range(cfg.window_size)
                                if numbers[t] >= 0 and table.valid[b, t].any()}
                with trace_range("classify"):
                    keep_masks = segment_filter.batch_call(table, frames_by_bt, crop_region,
                                                           timers=metrics.stage_seconds)
            for b, (frames, numbers, stamps) in enumerate(wins):
                ialm_iters.append(int(iters[b]))
                for t in range(cfg.window_size):
                    # Null frames (fn = -1) yield no segments: their RPCA output
                    # is null-space noise whose direction is solver-dependent
                    # (PARITY deviation 11).  The tracker still steps.
                    null_frame = numbers[t] < 0
                    centroids = [] if null_frame else frame_centroids(table, b, t)
                    keep = None
                    if not null_frame and keep_masks is not None:
                        keep = keep_masks.get((b, t), [])
                    elif not null_frame and segment_filter is not None:
                        keep = segment_filter(table, (b, t), frames[t], crop_region)
                    if keep is not None:
                        centroids = [c for c, k in zip(centroids, keep) if k]
                    tracker.step(centroids, numbers[t], stamps[t])
                    if export_segments_dir is not None and not null_frame:
                        # after the filter: a rejected segment writes no PNG
                        export_frame_segments(
                            frames[t], table, (b, t), numbers[t], crop_region,
                            export_segments_dir, Path(source.filepath).stem, cfg, keep=keep)
                    metrics.segments_total += len(centroids)
                    frames_processed += numbers[t] >= 0
                metrics.windows += 1
        metrics.batches += 1
        metrics.frames_processed = frames_processed
        if checkpoint_path is not None and metrics.batches % checkpoint_interval_batches == 0:
            src_info = checkpoint.source_fingerprint(source)
            if on_device is not None:
                # the checkpoint pairs this batch's cursor with this batch's
                # state, so a deferred event buffer must land first
                if deferred[0] is not None:
                    drain_device_events(*deferred[0])
                    deferred[0] = None
                checkpoint.save_checkpoint_device(
                    checkpoint_path, cursor[0], frames_processed, state_after,
                    tracker.events, source.fps, source_info=src_info)
            else:
                checkpoint.save_checkpoint(
                    checkpoint_path, cursor[0], frames_processed, tracker, source.fps,
                    source_info=src_info)

    def localize(payload):
        """One batch's tables and IALM iterations, from the prefetcher's
        payload: the raw gray batch or a wire codec packet, which is
        decoded on this device (before sharding, under a mesh)."""
        packed = isinstance(payload, (WirePacket, WirePacket6))
        if packed:
            N, H, W = payload.shape
            shape = (N // cfg.window_size, cfg.window_size, H, W)
        if mesh is None:
            if isinstance(payload, WirePacket6):
                return localize_windows_packed6(payload, shape, cfg, needs_frames, stab_ref)
            if isinstance(payload, WirePacket):
                return localize_windows_packed(payload, shape, cfg, needs_frames, stab_ref)
            return localize_windows_gray(payload, cfg, with_bbox=needs_frames, stab_ref=stab_ref)
        gray = decode_packet(payload).reshape(shape) if packed else payload
        # stabilisation on the whole batch, before sharding
        if cfg.stabilize_max_shift > 0:
            with metrics.span("stabilize"):
                gray, _ = stabilize_window(gray, cfg.stabilize_max_shift, stab_ref)
        return sharded_localize_windows_gray(gray, mesh, cfg, with_bbox=needs_frames)

    prefetcher = WindowPrefetcher(source, crop_region, device, cfg,
                                  initial_planned=frames_processed, keep_frames=needs_frames,
                                  frame_hw=None if ff is None else ff.shape[:2],
                                  metrics=metrics)
    profiler = _start_trace(device) if profiling else None
    # the ops below the runner book their spans into this run's metrics
    with bind(metrics):
        try:
            # dispatch batch k+1 before consuming batch k
            pending = None
            while True:
                with metrics.span("prefetch_wait"):
                    batch = prefetcher.next()
                nxt = None
                if batch is not None:
                    payload, wins, cursor = batch
                    with (metrics.span("localize", trace_name="localize_dispatch"),
                          device_stage("localize")):
                        table, iters = localize(payload)
                    on_device = None
                    if use_device_tracker:
                        # with frames kept, the scan is dispatched, and
                        # spanned, in consume (frames_on_device)
                        with (contextlib.nullcontext() if needs_frames
                              else metrics.span("track_dispatch")):
                            on_device = track_on_device(table, wins)
                    nxt = (table, iters, wins, cursor, on_device)
                if pending is not None:
                    with metrics.span("consume"):
                        consume(pending, nxt)
                    if status_cb is not None:
                        status_cb(frames_processed, source.total_frames)
                pending = nxt
                if nxt is None:
                    break
        finally:
            prefetcher.close()
            if profiler is not None:
                _stop_trace(profiler, profile_dir)
        if deferred[0] is not None:
            drain_device_events(*deferred[0])

    events = tracker.events
    metrics.events = len(events)
    metrics.ialm_iters = ialm_iters
    metrics.read_errors = source.read_errors
    # the bytes shipped: raw crops, or the codec's packets
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
    elif profiling:
        metrics.write_manifest(profile_dir / "run_manifest.json")
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
