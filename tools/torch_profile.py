#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one GPU.

    python3 tools/torch_profile.py [--runs 7] [--frames 2016] [--set field=value ...]

On the 1080p bench scene (`make_video(seed=0, n_frames=63, H=1080, W=1920,
n_entering=2, n_crossing=1, n_vanishing=1)`, 216 x 432 crop, the default
config with the --set overrides, e.g. `--set rpca_warm_basis=false` for
the cold-start solver), after the card's name and power limit:

  1. device and host milliseconds of each stage of one batch of 16 x 21
     frames (CUDA events, mean of 5 calls after a warm-up): RPCA, the
     post-filter (K1), label_components (K2 and any slow path), the label
     wrap and the region tables;
  2. `run_video` over `--frames` frames of the looped clip, `--runs` times
     in one process: frames/s, `stage_seconds` and peak device memory per
     run, then the median and quartile distance of the runs after the
     first;
  3. one more run under `torch.profiler`: wall time, summed device self
     time, the device's busy share, and the top operators.

Imports the port only (no JAX).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from swiftwatcher_tpu_torch import build  # noqa: E402
from swiftwatcher_tpu_torch.config import config_with_overrides  # noqa: E402
from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda  # noqa: E402
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners  # noqa: E402
from swiftwatcher_tpu_torch.io.source import LoopingArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.ops.ccl import label_components, wrap_labels_uint8  # noqa: E402
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host  # noqa: E402
from swiftwatcher_tpu_torch.ops.filtering import apply_postfilter  # noqa: E402
from swiftwatcher_tpu_torch.ops.props import region_tables  # noqa: E402
from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402


def timed(fn, reps: int = 5):
    """(device ms, host ms, last result) per call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, (time.perf_counter() - t0) * 1e3 / reps, out


def stage_times(bench, dev, cfg) -> None:
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    B, T = cfg.batch_windows, cfg.window_size
    idx = np.arange(B * T) % len(bench.frames)
    gray = bgr_to_gray_host(bench.frames[idx, y1:y2, x1:x2])
    H, W = gray.shape[1:]
    gray = torch.from_numpy(gray.reshape(B, T, H, W)).to(dev)
    stages = {}

    def stage(name, fn):
        device_ms, host_ms, out = timed(fn)
        stages[name] = (device_ms, host_ms)
        return out

    motion, iters = stage("rpca", lambda: rpca_motion_window_batched(gray, cfg))
    flat = motion.reshape(B * T, H, W)
    fg = stage("postfilter", lambda: apply_postfilter(flat, cfg)) > 0
    labels, _ = stage("label_components", lambda: label_components(fg, cfg.ccl_max_iters))
    lab8 = stage("wrap", lambda: wrap_labels_uint8(labels, cfg.label_modulus))
    stage("props", lambda: region_tables(lab8, with_bbox=False))
    print(f"RPCA iterations per window: {iters.tolist()}")
    print("per-batch stage (device ms, host ms) at "
          f"{B} windows x {T} frames x {H} x {W}: {json.dumps(stages)}", flush=True)


def run_once(bench, dev, cfg, frames: int):
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_video(LoopingArraySource(bench.frames, total=frames, fps=bench.fps),
                  bench.corners, cfg, dev)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--frames", type=int, default=2016)
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override a PipelineConfig field (repeatable)")
    args = ap.parse_args()
    cfg = config_with_overrides(args.set)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = require_cuda()
    pin_numerics()
    print(f"kernel build {build.build_all():.2f} s", flush=True)
    bench = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    print(f"config overrides: {args.set}", flush=True)
    stage_times(bench, dev, cfg)

    fps = []
    for run in range(args.runs):
        r, secs = run_once(bench, dev, cfg, args.frames)
        fps.append(r.frames_processed / secs)
        stages = {k: round(v, 4) for k, v in r.metrics.stage_seconds.items()}
        print(f"run {run}: {fps[-1]:.2f} frames/s over {r.frames_processed} frames in "
              f"{secs:.3f} s, {len(r.events)} events, peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, stage_seconds "
              f"{json.dumps(stages)}", flush=True)
    if len(fps) > 2:
        q1, med, q3 = np.percentile(fps[1:], [25, 50, 75])
        print(f"runs after the first: median {med:.2f} frames/s, quartile distance "
              f"{q3 - q1:.2f}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_once(bench, dev, cfg, args.frames)
    ka = prof.key_averages()
    # device time once: the kernels' own rows (operator rows repeat it)
    device_ms = sum(
        k.self_device_time_total for k in ka if k.device_type == DeviceType.CUDA
    ) / 1e3
    print(f"profiled run: wall {wall * 1e3:.1f} ms, summed device self time "
          f"{device_ms:.1f} ms, busy share {device_ms / (wall * 1e3):.3f}")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
