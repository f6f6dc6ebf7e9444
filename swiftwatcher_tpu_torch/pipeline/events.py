"""Whole-video event classification: flight angles -> labels, with numpy.

Counterpart of swiftwatcher_tpu/pipeline/events.py:classify_events, without
pandas.  Kept quirks of the reference:

  * angles that are exact multiples of 15 degrees are dropped, and the drop
    is by index label: every event sharing a dropped event's (timestamp,
    frame number) goes with it (here the key is the frame number, which
    determines the timestamp);
  * the histogram mode (36 bins over [-180-eps, 180+eps], interpolated) is
    clamped to -90 unless the modal bin edge lies strictly inside
    (-135, -45); the interpolation reads hist[i_max - 1], which wraps to the
    last bin when i_max == 0;
  * labels come from a right-closed band: 1 iff mode-30 < angle <= mode+30.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, PipelineConfig
from .tracking import Event

EPSILON = sys.float_info.epsilon


@dataclasses.dataclass
class ClassifiedEvents:
    """The events that survive the false-angle drop, in event order."""

    frame_numbers: np.ndarray  # int64
    angles: np.ndarray         # float64 degrees
    labels: np.ndarray         # int64, 1 = predicted, 0 = rejected

    @property
    def total_predicted(self) -> int:
        return int((self.labels > 0).sum())

    @property
    def total_rejected(self) -> int:
        return int((self.labels == 0).sum())


def event_angle(ev: Event) -> float:
    """First->last centroid angle, y negated."""
    del_y = ev.first_centroid[0] - ev.last_centroid[0]
    del_x = -1 * (ev.first_centroid[1] - ev.last_centroid[1])
    return math.degrees(math.atan2(del_y, del_x))


def compute_mode(angles: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG) -> float:
    """Interpolated histogram mode of the angles, clamped to the default
    outside cfg.mode_valid_range."""
    hist, edges = np.histogram(
        angles, bins=cfg.angle_hist_bins, range=[-180 - EPSILON, 180 + EPSILON]
    )
    i_max = int(np.argmax(hist))
    xl = edges[i_max]
    lo, hi = cfg.mode_valid_range
    if lo < xl < hi and i_max + 1 < len(hist):
        f0 = hist[i_max]
        f_1 = hist[i_max - 1]          # wraps to the last bin when i_max == 0
        f1 = hist[i_max + 1]
        w = abs(edges[1] - edges[0])
        return float(xl + ((f0 - f_1) / (2 * f0 - f1 - f_1)) * w)
    return cfg.default_mode


def classify_events(
    events: Sequence[Event], cfg: PipelineConfig = DEFAULT_CONFIG
) -> ClassifiedEvents:
    """Angle features -> false-angle drop -> band labels."""
    fns = np.array([ev.frame_number for ev in events], dtype=np.int64)
    angles = np.array([event_angle(ev) for ev in events], dtype=np.float64)
    false = np.remainder(angles, cfg.false_angle_multiple) == 0
    if cfg.false_angle_min_disp > 0:
        disp = np.array(
            [
                math.hypot(
                    ev.first_centroid[0] - ev.last_centroid[0],
                    ev.first_centroid[1] - ev.last_centroid[1],
                )
                for ev in events
            ],
            dtype=np.float64,
        )
        drop = false & (disp < cfg.false_angle_min_disp)  # by position
    else:
        drop = np.isin(fns, fns[false])                   # by index label
    kept = np.flatnonzero(~drop)
    angles = angles[kept]
    if len(kept):
        mode = compute_mode(angles, cfg)
        b = cfg.angle_band_halfwidth
        labels = ((angles > mode - b) & (angles <= mode + b)).astype(np.int64)
    else:
        labels = np.zeros(0, np.int64)
    return ClassifiedEvents(frame_numbers=fns[kept], angles=angles, labels=labels)


def labels_dataframe(classified: ClassifiedEvents, fps: float):
    """The JAX package's df_labels for CSV export (imports pandas): index
    (timestamp, framenumber), columns angle, label, events."""
    import pandas as pd

    from ..io.export import NULL_TIMESTAMP, frame_timestamp

    fns = classified.frame_numbers.tolist()
    df = pd.DataFrame(
        {
            "timestamp": [
                frame_timestamp(fn, fps) if fn >= 0 else NULL_TIMESTAMP for fn in fns
            ],
            "framenumber": fns,
            "angle": classified.angles,
        }
    )
    df.set_index(["timestamp", "framenumber"], inplace=True)
    df["label"] = classified.labels
    df["events"] = 1
    return df
