#!/usr/bin/env python3
"""The main thread's blocking reads of the card against the port's `sync.`
spans, and where the card idles, at a benchmark cell's shapes on one GPU.

    python3 tools/torch_sync_audit.py [--cell count.dusk ...] [--seed 7] [--batches 8]

For each cell of BENCHMARK.json named, the cell's configuration runs on its
traffic (swtbench's generator and gray-crop stream): two batches of warm-up,
`--batches` batches untraced, then `--batches` under torch.profiler (host
and CUDA).  One JSON line a cell, after the card's name and power limit:

  untraced   each span's host ms a batch and each counter a batch, from the
             run's RunMetrics (utils/metrics.py);
  traced     the synchronising runtime calls (cudaStreamSynchronize,
             cudaEventSynchronize, cudaDeviceSynchronize, a synchronous
             cudaMemcpy) on the main thread a batch, by the innermost
             `sync.` range that holds each, or "outside <range>" where no
             `sync.` range does; the `sync.` ranges a batch; for each of the
             main thread's ranges its wall ms a batch, the card's idle
             share inside it, and the device ms a batch of the kernels
             launched inside it.

The busy intervals are swtbench/trace.py's union, the kernels by range its
TraceSummary.  The per-range wall and idle and the count of synchronising
calls are what trace.py does not report yet; once it reports them, the
benchmark's readers take this tool's place.

Imports the port and swtbench (no JAX).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from swiftwatcher_tpu_torch.utils import metrics as metrics_mod  # noqa: E402
from swtbench import run as bench_run  # noqa: E402
from swtbench import spec  # noqa: E402
from swtbench.trace import (DEVICE_CATS, LAUNCH_CATS, MAIN_RANGE, TraceSummary,  # noqa: E402
                            _union)

SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def audit_events(events: list, batches: int) -> dict:
    """The traced part of the report (see the module docstring) from a
    Chrome trace's events, over `batches` traced batches."""
    ranges, calls, busy = [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if e.get("cat") == "user_annotation":
            ranges.append((ts, end, e.get("name", ""), e.get("tid")))
        elif e.get("cat") in LAUNCH_CATS and e.get("name") in SYNC_CALLS:
            calls.append((ts, e.get("tid")))
        elif e.get("cat") in DEVICE_CATS:
            busy.append((ts, end))
    main = next((r[3] for r in ranges if r[2] == MAIN_RANGE), None)
    mine = sorted(r for r in ranges if r[3] == main)

    syncs: dict = defaultdict(int)
    for t, tid in calls:
        if tid != main:
            continue
        held = [r for r in mine if r[0] <= t <= r[1]]
        inner = [r for r in held if r[2].startswith("sync.")]
        key = inner[-1][2] if inner else f"outside {held[-1][2] if held else 'any range'}"
        syncs[key] += 1

    # the card's busy intervals, merged, with a running sum of their length
    merged = _union(busy)
    starts = [a for a, _ in merged]
    run = [0.0]
    for a, b in merged:
        run.append(run[-1] + b - a)

    def busy_until(t):
        i = bisect.bisect_right(starts, t)
        return run[i] - (max(0.0, merged[i - 1][1] - t) if i else 0.0)

    wall: dict = defaultdict(float)
    idle: dict = defaultdict(float)
    for a, b, name, _ in mine:
        wall[name] += b - a
        idle[name] += (b - a) - (busy_until(b) - busy_until(a))
    kernel_s = TraceSummary.from_events(events, 0.0).range_kernel_s
    return {
        "sync_calls_per_batch": {k: v / batches for k, v in sorted(syncs.items())},
        "sync_ranges_per_batch": sum(1 for r in mine if r[2].startswith("sync.")) / batches,
        "ranges": {name: {"wall_ms": 1e3 * wall[name] / 1e6 / batches,
                          "idle_pct": 100.0 * idle[name] / wall[name] if wall[name] else None,
                          "kernel_ms": 1e3 * kernel_s.get(name, 0.0) / batches}
                   for name in sorted(wall)},
    }


def audit_cell(name: str, seed: int, batches: int, device: torch.device) -> dict:
    from swtbench import traffic
    from swtbench.source import StreamSource
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    cell = spec.load_cell(name)
    p, (H, W), corners, params, crop = bench_run.cell_inputs(cell)
    cfg = bench_run.program_config(p)
    B, T = int(p["batch_windows"]), int(p["window_size"])
    clip = traffic.generate(params, seed, H, W, crop)
    marks, prof = [], [None]

    def status(_frames, _total):
        run = metrics_mod.bound()
        marks.append((dict(run.stage_seconds), dict(run.counters)))
        done = len(marks) - 2
        if done == batches:
            prof[0] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                         torch.profiler.ProfilerActivity.CUDA])
            prof[0].start()
        elif done == 2 * batches:
            torch.cuda.synchronize(device)
            prof[0].stop()

    source = StreamSource(clip, (2 * batches + 4) * B * T)
    run_video(source, corners, cfg, device, tracker_impl=cell.config["tracker_impl"],
              status_cb=status)
    (st0, c0), (st1, c1) = marks[1], marks[1 + batches]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof[0].export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    return {
        "cell": name, "seed": seed, "batches": batches,
        "untraced": {
            "ms_per_batch": {k: 1e3 * (v - st0.get(k, 0.0)) / batches
                             for k, v in sorted(st1.items())},
            "per_batch": {k: (v - c0.get(k, 0)) / batches for k, v in sorted(c1.items())},
        },
        "traced": audit_events(events, batches),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", help="a workload of BENCHMARK.json "
                    "(repeatable; default: every cell)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench_run.pin_caches()
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    cells = args.cell or [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")
                          ["workloads"]]
    for name in cells:
        print(json.dumps(audit_cell(name, args.seed, args.batches, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
