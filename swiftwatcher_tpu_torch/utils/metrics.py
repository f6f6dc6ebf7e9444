"""Structured run metrics.

The port's copy of swiftwatcher_tpu/utils/metrics.py.  The reference's only
observability is two stdout lines (ui.py:216-227); these are structured
per-stage counters (frames/sec, segments/frame, IALM iterations, events),
exportable as a JSON run manifest.

Spans.  `RunMetrics.span(name)` times a block into
stage_seconds[name], counts it in counters[name] and, while a
torch.profiler session runs, opens a range in its trace (`trace_name`, or
the span's own name), so that host seconds and device trace share one set
of names.  run_video binds its RunMetrics to its thread for the length of
the call (`bind`), and the prefetcher's worker binds the same object on its
own thread; the ops below the runner call the module-level `span`, which
books into the run bound on the calling thread and, with no run bound,
books nothing but still opens the trace range; `count` books a counter
with no span the same way.  `counters` stays out of the manifest, whose
keys are the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch


@dataclasses.dataclass
class RunMetrics:
    started_unix: float = dataclasses.field(default_factory=time.time)
    frames_processed: int = 0
    windows: int = 0
    batches: int = 0
    segments_total: int = 0
    events: int = 0
    ialm_iters: List[int] = dataclasses.field(default_factory=list)
    read_errors: int = 0
    wire_bytes: int = 0       # bytes enqueued host->device
    track_overflows: int = 0  # frames whose segments exceeded max_tracks
                              # (device tracker only; the host tracker has
                              # no capacity)
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # DEVICE time per stage, filled only by a profiled run (run_video's
    # profile_dir: forced-completion waits of "localize" and "track_scan")
    device_stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # how many times each span ran
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    _stage_t0: Dict[str, float] = dataclasses.field(default_factory=dict, repr=False)

    def stage_start(self, name: str) -> None:
        self._stage_t0[name] = time.perf_counter()

    def stage_stop(self, name: str) -> None:
        t0 = self._stage_t0.pop(name, None)
        if t0 is not None:
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @contextlib.contextmanager
    def span(self, name: str, trace_name: Optional[str] = None) -> Iterator[None]:
        """Time the block into stage_seconds[name] and count it; under a
        profiler, also a trace range named trace_name (default: name)."""
        self.counters[name] = self.counters.get(name, 0) + 1
        with trace_range(trace_name or name):
            self.stage_start(name)
            try:
                yield
            finally:
                self.stage_stop(name)

    def device_stage_add(self, name: str, seconds: float) -> None:
        self.device_stage_seconds[name] = (
            self.device_stage_seconds.get(name, 0.0) + seconds
        )

    @property
    def elapsed(self) -> float:
        return time.time() - self.started_unix

    @property
    def fps(self) -> float:
        e = self.elapsed
        return self.frames_processed / e if e > 0 else 0.0

    def summary(self) -> dict:
        it = self.ialm_iters
        return {
            "frames_processed": self.frames_processed,
            "windows": self.windows,
            "batches": self.batches,
            "frames_per_sec": round(self.fps, 2),
            "segments_total": self.segments_total,
            "segments_per_frame": round(
                self.segments_total / max(self.frames_processed, 1), 3
            ),
            "events": self.events,
            "ialm_iters_mean": round(sum(it) / len(it), 2) if it else None,
            "ialm_iters_max": max(it) if it else None,
            "read_errors": self.read_errors,
            "wire_bytes": self.wire_bytes,
            "track_overflows": self.track_overflows,
            "stage_seconds": {k: round(v, 3) for k, v in self.stage_seconds.items()},
            "device_stage_seconds": {
                k: round(v, 3) for k, v in self.device_stage_seconds.items()
            },
            "elapsed_s": round(self.elapsed, 3),
        }

    def write_manifest(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)


_BOUND = threading.local()


def trace_range(name: str):
    """A record_function range while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def bound() -> Optional[RunMetrics]:
    """The run bound on this thread, or None."""
    return getattr(_BOUND, "metrics", None)


@contextlib.contextmanager
def bind(metrics: Optional[RunMetrics]) -> Iterator[Optional[RunMetrics]]:
    """Make `metrics` the run that span() books into on this
    thread for the block (None: no run), then restore the one before."""
    before = bound()
    _BOUND.metrics = metrics
    try:
        yield metrics
    finally:
        _BOUND.metrics = before


def count(name: str) -> None:
    """Add 1 to counters[name] of the run bound on this thread, if any: a
    counter with no span (a kernel's launches)."""
    metrics = bound()
    if metrics is not None:
        metrics.counters[name] = metrics.counters.get(name, 0) + 1


def span(name: str, trace_name: Optional[str] = None):
    """RunMetrics.span of the run bound on this thread; with none bound,
    only the trace range (under a profiler)."""
    metrics = bound()
    if metrics is None:
        return trace_range(trace_name or name)
    return metrics.span(name, trace_name)

