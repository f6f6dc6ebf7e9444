"""Frame-to-frame segment tracking and chimney-entry event detection (host).

Exact-semantics replication of the reference's SegmentTracker
(segment_tracking.py:17-263) operating on the per-frame segment tables
produced by the compiled window pipeline, instead of Python Segment objects.

Per-track state is reduced to sufficient statistics: everything downstream
(the angle cost, segment_tracking.py:200-247; event features,
event_classification.py:75-83; CSV indexing, event_classification.py:36-37)
depends only on a track's FIRST centroid, its current centroid, its history
length, and the last frame number/timestamp — not on the full history list
the reference carries.

The port's copy of swiftwatcher_tpu/pipeline/tracking.py.  This host
tracker is the parity path: it uses scipy's linear_sum_assignment, the very
function the reference calls.  The device tracker is
pipeline/tracking_device.py.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..config import PipelineConfig, DEFAULT_CONFIG

_EPS = sys.float_info.epsilon


@dataclasses.dataclass
class Track:
    """A segment in the previous frame plus its motion-path statistics."""

    centroid: Tuple[float, float]          # (row, col)
    frame_number: int
    timestamp: object                      # the source's stamp of the frame
    hist_len: int = 0                      # len(segment_history)
    hist_first: Optional[Tuple[float, float]] = None  # centroid of history[0]


@dataclasses.dataclass
class Event:
    """A 'segment disappeared inside the ROI' event (one potential swift)."""

    first_centroid: Tuple[float, float]
    last_centroid: Tuple[float, float]
    frame_number: int                      # of the disappeared segment
    timestamp: object


def _angle_cost(curr: Track, prev: Track, cfg: PipelineConfig) -> float:
    """2^(angle_difference - 90) vs the track's motion path; 1 with no
    history (segment_tracking.py:200-247)."""
    if prev.hist_len < 1:
        return 1.0
    iy, ix = prev.hist_first
    py, px = prev.centroid
    cy, cx = curr.centroid
    old_angle = math.degrees(math.atan2(iy - py, -1 * (ix - px)))
    new_angle = math.degrees(math.atan2(py - cy, -1 * (px - cx)))
    diff = abs(new_angle - old_angle)
    diff = min(diff, 360.0 - diff)
    return 2.0 ** (diff - cfg.angle_cost_knee)


def _distance_cost(curr: Track, prev: Track, cfg: PipelineConfig) -> float:
    """2^(euclidean - 25) (segment_tracking.py:189-197)."""
    d = math.hypot(prev.centroid[0] - curr.centroid[0], prev.centroid[1] - curr.centroid[1])
    try:
        return 2.0 ** (d - cfg.dist_cost_knee)
    except OverflowError:
        return math.inf


def build_cost_matrix(
    prev: Sequence[Track], curr: Sequence[Track], cfg: PipelineConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """(n_prev + n_curr)^2 matrix: impossible cells 1+eps, diagonal 1,
    match block [i, j + n_prev] = 0.5 d + 0.5 a (segment_tracking.py:46-102)."""
    n_prev, n_curr = len(prev), len(curr)
    n = n_prev + n_curr
    m = np.ones((n, n), np.float64) + _EPS
    for i, p in enumerate(prev):
        for j, c in enumerate(curr):
            m[i, j + n_prev] = 0.5 * _distance_cost(c, p, cfg) + 0.5 * _angle_cost(c, p, cfg)
    np.fill_diagonal(m, cfg.nonmatch_cost)
    return m


class SegmentTracker:
    """Two-frame tracking state machine over segment tables.

    roi_mask: crop-sized uint8 array, 255 = inside chimney ROI
    (the event test is roi_mask[int(y), int(x)] == 255,
    segment_tracking.py:161-166).
    """

    def __init__(self, roi_mask: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG):
        self.roi_mask = np.asarray(roi_mask)
        self.cfg = cfg
        self.prev: List[Track] = []
        self.events: List[Event] = []

    def step(
        self,
        centroids: Sequence[Tuple[float, float]],
        frame_number: int,
        timestamp,
    ) -> None:
        """Process one frame's segments (in label order)."""
        cfg = self.cfg
        curr = [
            Track(centroid=(float(cy), float(cx)), frame_number=frame_number, timestamp=timestamp)
            for cy, cx in centroids
        ]
        n_prev, n_curr = len(self.prev), len(curr)

        statuses_prev: List[object] = ["D"] * n_prev
        statuses_curr: List[object] = [None] * n_curr
        if n_prev + n_curr > 0:
            cost = build_cost_matrix(self.prev, curr, cfg)
            _, assignment = linear_sum_assignment(cost)
            for i in range(n_prev):
                j = int(assignment[i]) - n_prev
                if j >= 0:
                    statuses_prev[i] = j
                    statuses_curr[j] = i
            for j in range(n_curr):
                if int(assignment[n_prev + j]) - n_prev == j:
                    statuses_curr[j] = "A"

        # Link matched segments: history(curr) = history(prev) + [prev]
        # (segment_tracking.py:133-152).  A segment can finish with status
        # None (neither matched by a prev row nor self-assigned on its
        # diagonal); the reference would crash indexing with None at
        # segment_tracking.py:139-140, so treating it as unlinked (hist
        # stays 0) is a deliberate, documented divergence — see PARITY.md.
        for j, st in enumerate(statuses_curr):
            if st != "A" and st is not None:
                p = self.prev[st]
                curr[j].hist_len = p.hist_len + 1
                curr[j].hist_first = p.hist_first if p.hist_len > 0 else p.centroid

        # Events: previous-frame segments that disappeared inside the ROI
        # with a non-empty history (segment_tracking.py:154-176).
        for i, st in enumerate(statuses_prev):
            if st != "D":
                continue
            p = self.prev[i]
            y, x = int(p.centroid[0]), int(p.centroid[1])
            if self.roi_mask[y, x] != 255:
                continue
            if p.hist_len < 1:
                continue
            self.events.append(
                Event(
                    first_centroid=p.hist_first,
                    last_centroid=p.centroid,
                    frame_number=p.frame_number,
                    timestamp=p.timestamp,
                )
            )

        self.prev = curr
