#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end 1080p frames/s on one card.

The counterpart of bench.py for swiftwatcher_tpu_torch.  It imports the
port and torch only.  It drives the product path (`run_video`: host
crop and grayscale -> batched localisation on the card -> the device
tracking scan -> events) over the synthetic 1080p bench scene, looped by
a memory-bounded source, and prints ONE JSON line on stdout:

    {"metric": "...", "value": N, "unit": "frames/sec", "e2e_median": N, ...}

then a {"detail": {...}} line on stderr.  `value` is the best of four
warm end-to-end samples and `e2e_median` their median; every sample list
is in the detail line.  Beside it: the --classify rate, the rates with
the windows already on the card (localisation alone, localisation plus
the tracking scan, the same with rpca_fixed_iters=15), the sharded
path's rate on a mesh of every visible card, a run from a real
container, the host's decode rate and the bytes on the wire.

"Resident" here means that the windows are already on the card, not
that a batch is one dispatch: the port's IALM solver reads whether any
window is still active once per iteration (ops/rpca.py), so the host
paces the solver's loop, and a resident rate includes that pacing.

Runs on the card unless --device says otherwise; --device cuda without
a card raises.  A kernel that fails to build or launch fails the run.

Usage: python3 bench_torch.py [--frames N] [--warmup-frames N]
       [--device cuda|cpu] [--resident-frames N] [--sharded-frames N]
       [--container-loops N] [--resident]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.device import card_line, device_from_arg, pin_numerics
from swiftwatcher_tpu_torch.geometry import (
    crop_region_from_corners,
    roi_crop_region_from_corners,
)
from swiftwatcher_tpu_torch.io import native_av
from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource, VideoFileSource
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container
from swiftwatcher_tpu_torch.ops.ccl_local import converge_frames
from swiftwatcher_tpu_torch.ops.ccl_sweep import sweep_chunk
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter
from swiftwatcher_tpu_torch.ops.ialm_front import ialm_front
from swiftwatcher_tpu_torch.ops.rank_compact import label_rank_fused, rank_seed_sweep
from swiftwatcher_tpu_torch.ops.roi_mask import generate_roi_mask
from swiftwatcher_tpu_torch.pipeline import tracking_device
from swiftwatcher_tpu_torch.pipeline.runner import run_video
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

METRIC = "1080p_frames_per_sec_per_chip_end_to_end"

# Each kernel wrapper of the port counts its launches (never its plain
# version's calls): the detail line reports them for every mode.
WRAPPERS = {
    "fused_motion_filter": fused_motion_filter,
    "label_rank_fused": label_rank_fused,
    "sweep_chunk": sweep_chunk,
    "converge_frames": converge_frames,
    "rank_seed_sweep": rank_seed_sweep,
    "ialm_front": ialm_front,
    "track_window": tracking_device.track_window,
}


def _launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def _launches_since(before: dict) -> dict:
    """The kernels launched since `before` (a _launches() snapshot)."""
    now = _launches()
    return {name: now[name] - before[name] for name in now if now[name] > before[name]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window_batch(cfg, video, to_gray: bool, device, w_use=None) -> torch.Tensor:
    """(B, T, ...) window batch on `device`, each slot starting two frames
    after the one before (bench.py's windows: convergence varies across
    the batch, and the IALM loop runs to its slowest window); to_gray
    grays the crops on the host, as the product path does."""
    (x1, y1), (x2, y2) = crop_region_from_corners(video.corners, cfg)
    if w_use is not None:
        x2 = x1 + w_use
    B, T = cfg.batch_windows, cfg.window_size
    n_src = video.frames.shape[0]
    if n_src <= T:
        raise ValueError("the benchmark clip must be longer than one window")
    wins = []
    for b in range(B):
        s = (2 * b) % (n_src - T)
        crop = video.frames[s : s + T, y1:y2, x1:x2, :]
        wins.append(bgr_to_gray_host(crop) if to_gray else crop)
    return torch.from_numpy(np.stack(wins)).to(device)


def _table_sums(table, iters) -> torch.Tensor:
    """Every table field the tracker reads and the iterations, summed on
    the device: (2,) int64."""
    fields = (table.area, table.sum_y, table.sum_x, table.valid)
    return torch.stack([
        sum(f.sum(dtype=torch.int64) for f in fields),
        iters.sum(dtype=torch.int64),
    ])


def _time_device_loop(run_one, frames: int, per_batch: int, device, restart=None) -> dict:
    """One warm call (then `restart()`, when given), then
    max(frames // per_batch, 1) calls queued back to back, each adding its
    (k,) int64 checksum into an accumulator on the device that is read
    once at the end.  Wall seconds between two synchronisations; on a
    card, CUDA-event seconds of the same span beside them, and the peak
    device memory of the mode (warm call included).  Eager torch runs
    every call, so no carry is needed to stop work being hoisted, as
    bench.py's fori_loop needs under XLA."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_one().cpu()
    if restart is not None:
        restart()
    n_batches = max(frames // per_batch, 1)
    _sync(device)
    events = None
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    start = time.perf_counter()
    acc = run_one()
    for _ in range(n_batches - 1):
        acc = acc + run_one()
    if events:
        events[1].record()
    sums = acc.cpu().tolist()                 # the read-back ends the run
    _sync(device)
    elapsed = time.perf_counter() - start
    n = n_batches * per_batch
    out = {"fps": n / elapsed, "device_fps": None, "batches": n_batches,
           "frames": n, "sums": sums, "peak_mib": None}
    if events:
        out["device_fps"] = n / (events[0].elapsed_time(events[1]) / 1e3)
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    return out


def resident_fps(cfg, video, device, frames=13440) -> dict:
    """Localisation throughput with the gray windows already on the card
    (`localize_windows_gray` on one batch, called back to back)."""
    batch = _window_batch(cfg, video, True, device)

    def run_one():
        return _table_sums(*localize_windows_gray(batch, cfg))

    return _time_device_loop(run_one, frames, cfg.batch_windows * cfg.window_size, device)


def resident_tracked_fps(cfg, video, device, frames=13440) -> dict:
    """Throughput of localisation and the device tracking scan (T1) with
    the windows already on the card, the tracker state carried from batch
    to batch: the card's rate for the whole pipeline, which an end-to-end
    run approaches when the host keeps up.  The checksum's third entry
    is the events the scan found."""
    device = torch.device(device)
    crop_region = crop_region_from_corners(video.corners, cfg)
    roi_region = roi_crop_region_from_corners(video.corners, cfg)
    roi = generate_roi_mask(video.frames[0], roi_region, crop_region, cfg,
                            device=device).contiguous()
    B, T = cfg.batch_windows, cfg.window_size
    batch = _window_batch(cfg, video, True, device)
    fns = torch.arange(B * T, dtype=torch.int32, device=device)
    active = torch.ones(B * T, dtype=torch.bool, device=device)
    state = [None]

    def restart():
        # the timed calls start from an empty tracker, as bench.py's do
        state[0] = tracking_device.empty_state(cfg.max_tracks, device)

    def run_one():
        table, iters = localize_windows_gray(batch, cfg)
        cy, cx, kvalid, _ = tracking_device.compact_tables(table, cfg.max_tracks)
        state[0], ev = tracking_device.track_window(
            state[0], roi, cy.reshape(B * T, -1), cx.reshape(B * T, -1),
            kvalid.reshape(B * T, -1), fns, cfg, active=active)
        return torch.cat([_table_sums(table, iters), ev.count.to(torch.int64).reshape(1)])

    restart()
    return _time_device_loop(run_one, frames, B * T, device, restart)


def sharded_resident_fps(cfg, video, device, frames=6720):
    """Throughput of the sharded localisation path (`parallel/mesh.py`)
    over a mesh of every visible card, BGR windows on the card.  On one
    card the mesh is (1, 1) and spawns no worker: this measures the mesh's
    machinery (its run loop, NCCL collectives of one rank) at no link
    cost.  Returns (timing, (data, model)); the mesh is closed on return."""
    from swiftwatcher_tpu_torch.parallel.mesh import make_mesh, sharded_localize_windows

    mesh = make_mesh(device=device)
    try:
        data, model = mesh.shape["data"], mesh.shape["model"]
        (x1, _), (x2, _) = crop_region_from_corners(video.corners, cfg)
        # this width-sharded path needs the crop width to tile over 'model'
        w_use = (x2 - x1) // model * model
        bcfg = dataclasses.replace(
            cfg, batch_windows=max(cfg.batch_windows // data * data, data))
        batch = _window_batch(bcfg, video, False, device, w_use=w_use)

        def run_one():
            return _table_sums(*sharded_localize_windows(batch, mesh, cfg))

        timing = _time_device_loop(run_one, frames, bcfg.batch_windows * bcfg.window_size,
                                   device)
        timing["batch_windows"] = bcfg.batch_windows
    finally:
        mesh.close()
    return timing, (data, model)


def _write_container(stem: Path, frames: np.ndarray, loops: int, fps: float,
                     codec: str = "auto"):
    """`frames` repeated `loops` times as an MP4: H.264 through libav and
    libx264 where they are built (the reference's capture format), else
    MPEG-4 Part 2 ("mp4v") through cv2's writer, the one MP4 codec that a
    host without libav can write.  codec "h264" or "mp4v" forces one.
    Returns (path, codec)."""
    if codec not in ("auto", "h264", "mp4v"):
        raise ValueError(f"unknown container codec {codec!r}")
    if codec in ("auto", "h264"):
        path = stem.with_name(stem.name + "_h264.mp4")
        if native_av.is_available() and native_av.write_test_video(
                path, np.tile(frames, (loops, 1, 1, 1)), fps=fps):
            return path, "h264"
        if codec == "h264":
            raise RuntimeError("no H.264 encoder here (the port's libav writer with libx264)")
    path = stem.with_name(stem.name + "_mp4v.mp4")
    if not write_container(path, (f for _ in range(loops) for f in frames), fps, "mp4v"):
        raise RuntimeError("cv2 cannot write an mp4v MP4 here")
    return path, "mp4v"


def host_decode_fps(video, cfg, passes=6, codec="auto"):
    """The host's container-decode rate of the product ingest path, on a
    freshly encoded MP4 of the bench scene (best of `passes`).  On H.264,
    where the libav backend's gray-crop decode matches cv2's, that decode
    (avpump.cpp's swt_av_read_gray_crop, which converts only the crop's
    rows); otherwise each of VideoFileSource's `parallel` and `cv2`
    backends that engages, with the crop grayed on the host as the
    prefetcher does.  Returns (fps, label, codec, {label: fps})."""
    crop = crop_region_from_corners(video.corners, cfg)
    (x1, y1), (x2, y2) = crop
    n = video.frames.shape[0]
    rates = {}
    with tempfile.TemporaryDirectory() as td:
        path, codec = _write_container(Path(td) / "decode_bench", video.frames, 1, video.fps,
                                       codec)
        if codec == "h264" and native_av.probe_gray_crop_parity(path, crop):
            best = 0.0
            for _ in range(passes):
                rd = native_av.AVReader.open(path)
                start = time.perf_counter()
                k = 0
                while rd.read_gray_crop(crop) is not None:
                    k += 1
                best = max(best, k / (time.perf_counter() - start))
                rd.close()
                if k != n:
                    raise RuntimeError(f"av gray-crop decode gave {k} of {n} frames")
            rates["av_gray_crop"] = round(best, 1)
        else:
            for backend in ("parallel", "cv2"):
                best = 0.0
                for _ in range(passes):
                    try:
                        src = VideoFileSource(path, backend=backend)
                    except ValueError:
                        break                   # the backend does not engage here
                    start = time.perf_counter()
                    k = 0
                    while src.next_frame_number < src.end_frame:
                        frame, _, _ = src.get_frame()
                        bgr_to_gray_host(frame[None, y1:y2, x1:x2])
                        k += 1
                    best = max(best, k / (time.perf_counter() - start))
                    src.close()
                if best:
                    rates[f"{backend}_gray_host"] = round(best, 1)
    label = max(rates, key=rates.get)
    return rates[label], label, codec, rates


def e2e_from_container_fps(cfg, video, device, loops=10, samples=3, codec="auto"):
    """The product path from a container file: MP4 -> VideoFileSource
    (its first backend that engages) -> the card -> events.  The bench
    scene is tiled `loops` times and encoded once; an untimed run pays the
    warm-up, then the best of `samples` timed runs is reported.

    Returns (fps, counts_equal, backend, sample_fps, codec): counts_equal
    holds the counts against an ArraySource run over the same decoded
    frames (both codecs are lossy, so the raw tiled frames are not the
    point of comparison; every backend is probe-gated byte-equal to cv2,
    so cv2's decode is what run_video consumed)."""
    n = loops * video.frames.shape[0]
    with tempfile.TemporaryDirectory() as td:
        path, codec = _write_container(Path(td) / "e2e_container", video.frames, loops,
                                       video.fps, codec)
        src = VideoFileSource(path)
        backend = src.backend
        run_video(src, video.corners, cfg, device, tracker_impl="device")
        sample_fps = []
        for _ in range(samples):
            src = VideoFileSource(path)          # a fresh cursor
            _sync(device)
            start = time.perf_counter()
            res = run_video(src, video.corners, cfg, device, tracker_impl="device")
            _sync(device)
            sample_fps.append(round(res.frames_processed / (time.perf_counter() - start), 1))
        cap = VideoFileSource(path, backend="cv2")
        dec = np.empty((n, *video.frames.shape[1:]), np.uint8)
        for i in range(n):
            f = cap.read_frame(i)
            if f is None:
                raise RuntimeError(f"the cv2 decode of the reference stopped at frame {i}")
            dec[i] = f
        cap.close()
    ref = run_video(ArraySource(dec, fps=video.fps), video.corners, cfg, device,
                    tracker_impl="device")
    counts_equal = (
        res.total_predicted == ref.total_predicted
        and res.total_rejected == ref.total_rejected
        and len(res.events) == len(ref.events)
    )
    return max(sample_fps), counts_equal, backend, sample_fps, codec


def _arm_watchdog():
    """Print a zero-value error line and exit 3 after BENCH_WATCHDOG_SECS
    (default 2700 s, far beyond a healthy run of a few minutes): a hung
    CUDA call or collective cannot be interrupted from Python, and would
    otherwise leave the run with no output at all.  Cancel the returned
    timer when done."""
    secs = float(os.environ.get("BENCH_WATCHDOG_SECS", "2700"))

    def fire():
        print(json.dumps({
            "metric": METRIC, "value": 0, "unit": "frames/sec",
            "error": f"watchdog: no result after {int(secs)} s (a CUDA call, a "
                     "collective or the host hung); no measurement taken",
        }), flush=True)
        os._exit(3)

    t = threading.Timer(secs, fire)
    t.daemon = True
    t.start()
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1680)
    # three full batches: the warm-up pays the kernels' build and loads,
    # cuBLAS's and cuSOLVER's handles, and the caching allocator's pools
    ap.add_argument("--warmup-frames", type=int, default=1008)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch-windows", type=int, default=DEFAULT_CONFIG.batch_windows)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--resident-frames", type=int, default=13440,
                    help="frames of each resident and resident-tracked mode")
    ap.add_argument("--sharded-frames", type=int, default=6720,
                    help="frames of the sharded resident mode")
    ap.add_argument("--container-loops", type=int, default=10,
                    help="repetitions of the scene in the from-container file")
    ap.add_argument("--resident", action="store_true",
                    help="print only the resident localisation rate")
    args = ap.parse_args(argv)

    device = device_from_arg(args.device)
    if device.type == "cuda":
        pin_numerics()
    watchdog = _arm_watchdog()
    try:
        return _run(args, device)
    finally:
        watchdog.cancel()


def _run(args, device: torch.device) -> int:
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=args.batch_windows)
    card = card_line(device)
    # the 1080p bench scene: a ~400 px chimney, a 216 x 432 crop
    video = make_video(seed=0, n_frames=63, H=args.height, W=args.width,
                       n_entering=2, n_crossing=1, n_vanishing=1)

    if args.resident:
        rcfg = dataclasses.replace(cfg, batch_windows=max(args.batch_windows, 32))
        r = resident_fps(rcfg, video, device, frames=args.resident_frames)
        print(json.dumps({
            "metric": "1080p_frames_per_sec_per_chip_resident",
            "value": round(r["fps"], 2), "unit": "frames/sec",
            "device_frames_per_sec": r["device_fps"] and round(r["device_fps"], 2),
            "peak_device_mib": r["peak_mib"] and round(r["peak_mib"], 1),
            "batch_windows": rcfg.batch_windows, "card": card,
        }))
        return 0

    # The shipped defaults: the device tracker (the CLI's), the enumeration
    # LAP, wire_codec=auto.  The warm-up pays every first-use cost.
    def looped(total):
        return LoopingArraySource(video.frames, total=total, fps=video.fps)

    run_video(looped(args.warmup_frames), video.corners, cfg, device, tracker_impl="device")
    launches = {}
    e2e_samples = []
    result = None
    before = _launches()
    for _ in range(4):
        _sync(device)
        start = time.perf_counter()
        res = run_video(looped(args.frames), video.corners, cfg, device, tracker_impl="device")
        _sync(device)
        elapsed_i = time.perf_counter() - start
        fps_i = res.frames_processed / elapsed_i
        e2e_samples.append(round(fps_i, 2))
        if result is None or fps_i > fps:
            result, fps, elapsed = res, fps_i, elapsed_i
    launches["e2e"] = _launches_since(before)

    # --classify: the SqueezeNet keep-mask on the device tracker
    from swiftwatcher_tpu_torch.models.classifier import SqueezeNetSegmentFilter

    filt = SqueezeNetSegmentFilter.from_default_weights(cfg, device)
    run_video(looped(args.warmup_frames), video.corners, cfg, device, segment_filter=filt,
              tracker_impl="device")
    c_samples = []
    c_result = None
    c_upload_bytes = 0
    before = _launches()
    for _ in range(3):
        ub0 = filt.upload_bytes
        _sync(device)
        start = time.perf_counter()
        c_res = run_video(looped(args.frames), video.corners, cfg, device,
                          segment_filter=filt, tracker_impl="device")
        _sync(device)
        c_fps_i = c_res.frames_processed / (time.perf_counter() - start)
        c_samples.append(round(c_fps_i, 2))
        if c_result is None or c_fps_i > c_fps:
            c_result, c_fps = c_res, c_fps_i
            c_upload_bytes = filt.upload_bytes - ub0
    launches["classify"] = _launches_since(before)

    # the windows already on the card
    resident = {}
    for name, fn, rcfg, frames in (
        ("resident", resident_fps, dataclasses.replace(cfg, batch_windows=64),
         args.resident_frames),
        ("resident_tracked", resident_tracked_fps, dataclasses.replace(cfg, batch_windows=32),
         args.resident_frames),
        # the opt-in fixed-trip IALM (dynamic stopping stays the default)
        ("resident_tracked_fixed_rpca", resident_tracked_fps,
         dataclasses.replace(cfg, batch_windows=32, rpca_fixed_iters=15),
         args.resident_frames),
    ):
        before = _launches()
        resident[name] = fn(rcfg, video, device, frames=frames)
        resident[name]["batch_windows"] = rcfg.batch_windows
        launches[name] = _launches_since(before)
    before = _launches()
    sharded, mesh_shape = sharded_resident_fps(dataclasses.replace(cfg, batch_windows=64),
                                               video, device, frames=args.sharded_frames)
    launches["sharded_resident"] = _launches_since(before)

    fc_fps = fc_counts_equal = fc_backend = fc_samples = fc_codec = None
    try:
        fc_fps, fc_counts_equal, fc_backend, fc_samples, fc_codec = e2e_from_container_fps(
            cfg, video, device, loops=args.container_loops)
    except Exception as e:  # reported as null; a caller that needs it fails on that
        print(f"[bench_torch] from-container sample failed: {type(e).__name__}: {e}",
              file=sys.stderr)

    d_fps, d_label, d_codec, d_rates = host_decode_fps(video, cfg)

    (cx1, cy1), (cx2, cy2) = crop_region_from_corners(video.corners, cfg)
    crop_bytes = (cy2 - cy1) * (cx2 - cx1)
    wire_bytes = result.metrics.wire_bytes
    wire_mbps = wire_bytes / elapsed / 1e6
    wire_bpf = wire_bytes / max(result.frames_processed, 1)

    print(json.dumps({
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": "frames/sec",
        "e2e_median": round(float(np.median(e2e_samples)), 2),
        "classified_frames_per_sec": round(c_fps, 2),
        "resident_frames_per_sec": round(resident["resident"]["fps"], 2),
        "resident_tracked_frames_per_sec": round(resident["resident_tracked"]["fps"], 2),
        "resident_tracked_fixed_rpca_frames_per_sec":
            round(resident["resident_tracked_fixed_rpca"]["fps"], 2),
        "sharded_resident_frames_per_sec": round(sharded["fps"], 2),
        "sharded_mesh": list(mesh_shape),
        "e2e_from_container_fps": fc_fps,
        "note": (
            f"one {device.type} device ({card or 'the CPU'}); e2e runs the shipped "
            "defaults (device tracker, enumeration LAP, auto wire codec) through "
            f"run_video and shipped {wire_bpf:.0f} B/frame (raw crop {crop_bytes} "
            f"B/frame) = {wire_mbps:.1f} MB/s; resident = localisation with the "
            "windows already on the device (the IALM loop still reads its stop "
            "flag on the host once per iteration); resident_tracked = "
            "localisation + the device tracking scan (T1), the device's rate for "
            "the whole pipeline; resident_tracked_fixed_rpca = the same with the "
            "opt-in rpca_fixed_iters=15; sharded_resident = BGR windows through "
            "parallel/mesh.py on a mesh of every visible device; "
            f"e2e_from_container = {fc_codec} MP4 through VideoFileSource "
            f"({fc_backend})"
        ),
    }), flush=True)
    print(json.dumps({"detail": {
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "frames": result.frames_processed,
        "elapsed_s": round(elapsed, 3),
        "e2e_samples_fps": e2e_samples,
        "classified_samples_fps": c_samples,
        "classified_predicted": c_result.total_predicted,
        # the classify path's stages in the best sample: readback, crop,
        # pack, device (upload + preprocess + CNN + keep read-back); the
        # bytes of canvases and tables it uploaded
        "classified_stage_seconds": {
            k: round(v, 3) for k, v in sorted(c_result.metrics.stage_seconds.items())
            if k.startswith("classify") or k == "consume"
        },
        "classified_upload_bytes": c_upload_bytes,
        "resident": {name: {k: (round(v, 2) if isinstance(v, float) else v)
                            for k, v in r.items()} for name, r in resident.items()},
        "sharded_resident": {k: (round(v, 2) if isinstance(v, float) else v)
                             for k, v in sharded.items()},
        "e2e_from_container_fps": fc_fps,
        "from_container_counts_equal": fc_counts_equal,
        "from_container_backend": fc_backend,
        "from_container_codec": fc_codec,
        "from_container_samples_fps": fc_samples,
        "events": len(result.events),
        "predicted": result.total_predicted,
        "rejected": result.total_rejected,
        "batch_windows": cfg.batch_windows,
        "launches": launches,
        "host_decode_fps_1080p": d_fps,
        "host_decode_backend": d_label,
        "host_decode_codec": d_codec,
        "host_decode_fps_by_backend": d_rates,
        "host_cores": os.cpu_count(),
        "crop_bytes_per_frame": crop_bytes,
        "wire_bytes_per_frame": round(wire_bpf),
        "e2e_wire_MBps": round(wire_mbps, 1),
    }}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
