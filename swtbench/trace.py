"""The benchmark's own device trace of the window (`--trace 1`).

A `torch.profiler` session (host and CUDA activities) runs over the
second half of the window: from the first batch completed after half its
seconds to the first completed after its close.  Its Chrome trace is read
once the run is over and then deleted.  From it:

  busy_s        the union of the intervals in which a kernel, a copy or a
                memset ran on the device;
  range_kernel_s / range_count
                per host range (the program's record_function ranges:
                localize_dispatch, track_dispatch, consume and its kernel
                launchers' swt_* ranges), the device time of the kernels
                launched inside it (a kernel belongs to every range on its
                launching thread that holds the launch call), and how many
                such ranges closed inside the trace;
  device_ops    the kernels that took most time, by name;
  idle_gaps     the device's idle time, by the innermost range the
                launching thread was in when the device went idle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MAIN_RANGE = "localize_dispatch"


class Tracer:
    """Starts and stops the session and reads its trace."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.prof = None
        self.t_start = self.t_stop = None
        # the host and CPU seconds that stopping the session took
        self.stop_s = self.stop_cpu_s = 0.0

    def _session(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def warm(self) -> None:
        """A first session around a small op, so that the profiler's own
        start-up falls in set-up."""
        with self._session():
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        self.prof = self._session()
        self.prof.start()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.t_stop is not None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        cpu = time.process_time()
        self.prof.stop()
        self.stop_s = time.perf_counter() - self.t_stop
        self.stop_cpu_s = time.process_time() - cpu

    def summary(self) -> Optional["TraceSummary"]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        return TraceSummary.from_events(events, self.t_stop - self.t_start)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class TraceSummary:
    def __init__(self, window_s, busy_s, range_kernel_s, range_count, device_ops, idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.range_kernel_s: Dict[str, float] = range_kernel_s
        self.range_count: Dict[str, int] = range_count
        self.device_ops: List[list] = device_ops
        self.idle_gaps: List[list] = idle_gaps

    @classmethod
    def from_events(cls, events: list, window_s: float) -> "TraceSummary":
        device, launches, ranges = [], {}, []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or "ts" not in e:
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, cat, e.get("name", ""),
                               e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                ranges.append((ts, ts + dur, e.get("name", ""), e.get("tid")))

        busy = _union([(a, b) for a, b, *_ in device])
        busy_s = sum(b - a for a, b in busy) / 1e6

        by_tid = defaultdict(list)
        for r in ranges:
            by_tid[r[3]].append(r)
        for rs in by_tid.values():
            rs.sort()
        range_count: Dict[str, int] = defaultdict(int)
        for _, _, name, _ in ranges:
            range_count[name] += 1

        def holding(tid, t):
            """The ranges of thread `tid` that hold time t, outermost first."""
            rs = by_tid.get(tid, [])
            i = bisect.bisect_right(rs, (t, float("inf")))
            return [r for r in rs[:i] if r[1] >= t]

        # each thread's kernel launches in time order, with a running sum
        # of their kernels' device seconds
        op_s: Dict[str, float] = defaultdict(float)
        per_tid = defaultdict(list)
        for a, b, cat, name, corr in device:
            if cat != "kernel":
                continue
            op_s[name] += (b - a) / 1e6
            launch = launches.get(corr)
            if launch is not None:
                per_tid[launch[0]].append((launch[1], (b - a) / 1e6))
        sums = {}
        for tid, ks in per_tid.items():
            ks.sort()
            run, acc = [0.0], 0.0
            for _, d in ks:
                acc += d
                run.append(acc)
            sums[tid] = ([t for t, _ in ks], run)
        range_kernel_s: Dict[str, float] = defaultdict(float)
        for a, b, name, tid in ranges:
            if tid in sums:
                times, run = sums[tid]
                range_kernel_s[name] += (run[bisect.bisect_right(times, b)]
                                         - run[bisect.bisect_left(times, a)])

        # idle gaps, by the innermost range of the main thread at the gap
        main = next((r[3] for r in ranges if r[2] == MAIN_RANGE), None)
        if busy:
            t0 = min([busy[0][0]] + [r[0] for r in ranges])
            t1 = max([busy[-1][1]] + [r[1] for r in ranges])
        else:
            t0 = t1 = 0.0
        gaps = []
        edge = t0
        for a, b in busy + [(t1, t1)]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            inner = holding(main, a)
            idle[inner[-1][2] if inner else "prefetch_wait_or_other"] += (b - a) / 1e6

        def top(d):
            return [[k[:80], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return cls(window_s, busy_s, dict(range_kernel_s), dict(range_count), top(op_s),
                   top(idle))
