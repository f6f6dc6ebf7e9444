#!/usr/bin/env python
"""Soak of the PyTorch port's shipped defaults over a long looping stream.

Counterpart of tools/soak_chip.py.  Runs passes of the port's run_video
with the shipped defaults (the device tracker, the enumeration LAP,
wire_codec=auto) over the bench scene looped --loops times, until
--min-wall-secs have passed and at least --min-passes passes have run.
Every pass must give exactly --loops times the events of one loop (the
scene's actors are time-boxed, so counts scale exactly unless the tracker
leaks or drops state across batches).  Each pass records the host RSS
(/proc/self/status VmRSS) and, on a card, torch.cuda's allocated, peak
allocated and reserved bytes, so leak evidence is a memory curve.

Usage: python tools/torch_soak.py [--loops 20] [--min-wall-secs 1800]
           [--min-passes 1] [--device cuda|cpu] [--out SOAK.json]
Prints one JSON line per pass, then a summary line.  Runs on the card
unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import card_line, device_from_arg  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return round(int(line.split()[1]) / 1024.0, 1)
    return -1.0


def _device_mem(device: torch.device) -> dict | None:
    """torch.cuda's memory counters of the card, in bytes (None on the CPU)."""
    if device.type != "cuda":
        return None
    return {"memory_allocated": torch.cuda.memory_allocated(device),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "memory_reserved": torch.cuda.memory_reserved(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loops", type=int, default=20, help="scene repetitions per pass")
    ap.add_argument("--min-wall-secs", type=float, default=0.0,
                    help="keep running passes until this much wall time has elapsed")
    ap.add_argument("--min-passes", type=int, default=1,
                    help="run at least this many passes")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="write the summary JSON here as well")
    args = ap.parse_args(argv)

    device = device_from_arg(args.device)
    watchdog = bench_torch._arm_watchdog()
    try:
        return _soak(args, device)
    finally:
        watchdog.cancel()


def _soak(args, device: torch.device) -> int:
    cfg = DEFAULT_CONFIG
    video = make_video(seed=0, n_frames=63, H=args.height, W=args.width,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    # the truth of one loop, from a single pass over the clip (same config)
    base = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, device,
                     tracker_impl="device")

    total = args.loops * video.frames.shape[0]
    t_start = time.perf_counter()
    passes = []
    all_ok = True
    while True:
        src = LoopingArraySource(video.frames, total=total, fps=video.fps)
        rss0 = _rss_mb()
        t0 = time.perf_counter()
        res = run_video(src, video.corners, cfg, device, tracker_impl="device")
        dt = time.perf_counter() - t0
        ok = (
            res.total_predicted == args.loops * base.total_predicted
            and res.total_rejected == args.loops * base.total_rejected
            and len(res.events) == args.loops * len(base.events)
            and res.frames_processed == total
        )
        all_ok = all_ok and ok
        row = {
            "pass": len(passes),
            "frames": res.frames_processed,
            "fps": round(res.frames_processed / dt, 1),
            "counts_scale_exactly": ok,
            "rss_mb_before": rss0,
            "rss_mb_after": _rss_mb(),
            "device_mem": _device_mem(device),
            "wall_s": round(time.perf_counter() - t_start, 1),
        }
        passes.append(row)
        print(json.dumps(row), flush=True)
        if (time.perf_counter() - t_start >= args.min_wall_secs
                and len(passes) >= args.min_passes):
            break

    rss_curve = [p["rss_mb_after"] for p in passes]
    summary = {
        "frames_total": sum(p["frames"] for p in passes),
        "passes": len(passes),
        "loops_per_pass": args.loops,
        "wall_s": round(time.perf_counter() - t_start, 1),
        "fps_median": round(float(np.median([p["fps"] for p in passes])), 1),
        "events_per_loop": len(base.events),
        "counts_scale_exactly": all_ok,
        "rss_mb_curve": rss_curve,
        "rss_mb_growth": round(rss_curve[-1] - rss_curve[0], 1) if len(rss_curve) > 1 else 0.0,
        "device_mem_last": passes[-1]["device_mem"],
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "card": card_line(device),
        "config": {"track_enum_lap": cfg.track_enum_lap, "tracker": "device"},
        "per_pass": passes,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
