"""Tracking, events and their labels, as the original states them.

  Tracker        segment_tracking.py:17-263: a square cost matrix over the
                 previous and current frames' segments (impossible cells
                 1 + eps, the diagonal the non-match cost, the match block
                 0.5 * 2^(distance - 25) + 0.5 * 2^(angle change - 90)),
                 solved by scipy's linear_sum_assignment; a previous
                 segment left unmatched inside the ROI with a history is an
                 event (first and last centroid, its frame number).
  Labels         event_classification.py:47-141: flight angle, the drop of
                 angles that are multiples of 15 degrees, the interpolated
                 histogram mode (36 bins, trusted inside (-135, -45)), the
                 band mode - 30 < angle <= mode + 30.  Under the accuracy
                 pack the band's half-width and a minimum displacement for
                 the drop come from the configuration.
"""

from __future__ import annotations

import math
import sys
from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

EPS = sys.float_info.epsilon


class Tracker:
    """Two-frame tracking over per-frame centroid lists."""

    def __init__(self, roi: np.ndarray, p: dict):
        self.roi = roi
        self.knee_d = float(p["dist_cost_knee"])
        self.knee_a = float(p["angle_cost_knee"])
        self.nonmatch = float(p["nonmatch_cost"])
        # a segment: [centroid, frame number, first centroid of its history
        # or None, history length]
        self.prev: list = []
        self.events: List[Tuple[Tuple[float, float], Tuple[float, float], int]] = []

    def _cost(self, p, c) -> float:
        d = math.dist(p[0], c)
        try:
            d_cost = 2.0 ** (d - self.knee_d)
        except OverflowError:
            d_cost = math.inf
        if p[3] > 0:
            (iy, ix), (py, px), (cy, cx) = p[2], p[0], c
            old = math.degrees(math.atan2(iy - py, -(ix - px)))
            new = math.degrees(math.atan2(py - cy, -(px - cx)))
            ad = abs(new - old)
            a_cost = 2.0 ** (min(ad, 360 - ad) - self.knee_a)
        else:
            a_cost = 1.0
        return 0.5 * d_cost + 0.5 * a_cost

    def step(self, centroids: Sequence[Tuple[float, float]], fn: int) -> None:
        prev = self.prev
        curr = [[(float(cy), float(cx)), fn, None, 0] for cy, cx in centroids]
        n_prev, n_curr = len(prev), len(curr)
        if n_prev + n_curr == 0:
            return
        n = n_prev + n_curr
        cost = np.ones((n, n)) + EPS
        for i, p in enumerate(prev):
            for j, c in enumerate(curr):
                cost[i, j + n_prev] = self._cost(p, c[0])
        np.fill_diagonal(cost, self.nonmatch)
        _, assign = linear_sum_assignment(cost)
        for i, p in enumerate(prev):
            j = int(assign[i]) - n_prev
            if j >= 0:
                c = curr[j]
                c[2] = p[2] if p[3] > 0 else p[0]
                c[3] = p[3] + 1
            else:
                y, x = int(p[0][0]), int(p[0][1])
                if self.roi[y, x] == 255 and p[3] >= 1:
                    self.events.append((p[2], p[0], p[1]))
        self.prev = curr


def labels(events, p: dict) -> Tuple[int, int]:
    """(predicted, rejected) totals of the events."""
    if not events:
        return 0, 0
    fns = np.array([e[2] for e in events], np.int64)
    angles = np.array([math.degrees(math.atan2(f[0] - l[0], -(f[1] - l[1])))
                       for f, l, _ in events])
    false = np.remainder(angles, float(p["false_angle_multiple"])) == 0
    if float(p["false_angle_min_disp"]) > 0:
        disp = np.array([math.hypot(f[0] - l[0], f[1] - l[1]) for f, l, _ in events])
        drop = false & (disp < float(p["false_angle_min_disp"]))
    else:
        # the original drops by index label: every event of a dropped
        # event's frame goes with it
        drop = np.isin(fns, fns[false])
    kept = angles[~drop]
    if not kept.size:
        return 0, 0
    hist, edges = np.histogram(kept, bins=int(p["angle_hist_bins"]),
                               range=[-180 - EPS, 180 + EPS])
    i_max = int(np.argmax(hist))
    xl = edges[i_max]
    lo, hi = p["mode_valid_range"]
    if lo < xl < hi and i_max + 1 < len(hist):
        f0, f_1, f1 = hist[i_max], hist[i_max - 1], hist[i_max + 1]
        mode = xl + ((f0 - f_1) / (2 * f0 - f1 - f_1)) * abs(edges[1] - edges[0])
    else:
        mode = float(p["default_mode"])
    b = float(p["angle_band_halfwidth"])
    predicted = int(((kept > mode - b) & (kept <= mode + b)).sum())
    return predicted, int(kept.size) - predicted
