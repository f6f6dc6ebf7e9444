"""Port vs JAX package: event classification (labels and kept rows equal,
angles to the last bit), including the label-based duplicate-index drop."""

import dataclasses

import numpy as np
import pytest

from swiftwatcher_tpu.config import DEFAULT_CONFIG
from swiftwatcher_tpu.io.export import frame_timestamp
from swiftwatcher_tpu.pipeline.events import classify_events as jax_classify_events
from swiftwatcher_tpu.pipeline.tracking import Event
from swiftwatcher_tpu_torch.pipeline.events import classify_events, labels_dataframe

FPS = 30.0


def _ev(first, last, fn):
    return Event(first_centroid=first, last_centroid=last, frame_number=fn,
                 timestamp=frame_timestamp(fn, FPS))


def _angle_events(angles, fns):
    evs = []
    for a, fn in zip(angles, fns):
        rad = np.deg2rad(a)
        evs.append(_ev((10.0, 10.0), (10.0 - 3 * np.sin(rad), 10.0 + 3 * np.cos(rad)), fn))
    return evs


SCENES = {
    "band": _angle_events(
        [-130, -95, -91, -89, -88, -59, -40, -10, 44, 179, -170],
        range(100, 540, 40),
    ),
    # a -90 (exact multiple of 15) event shares its frame number with two
    # others: the reference's index-label drop takes all three
    "duplicate_index": [
        _ev((10.0, 10.0), (20.0, 10.0), 50),        # -90 exactly: dropped
        _ev((10.0, 10.0), (20.0, 12.0), 50),        # same index: dropped too
        _ev((10.0, 10.0), (21.0, 13.0), 50),
        _ev((10.0, 10.0), (20.0, 11.0), 51),
        _ev((10.0, 10.0), (19.0, 12.0), 80),
        _ev((10.0, 10.0), (10.0, 20.0), 81),        # 0 exactly: dropped
    ],
    "all_dropped": [_ev((10.0, 10.0), (20.0, 10.0), 5)],
    "mode_in_first_bin": _angle_events([-179.5, -179.0, -178.0, 10.0], [1, 2, 3, 4]),
}


def _compare(events, cfg):
    want = jax_classify_events(events, cfg)
    got = classify_events(events, cfg)
    rows = want.reset_index()
    assert got.frame_numbers.tolist() == rows["framenumber"].tolist()
    np.testing.assert_array_equal(got.angles, rows["angle"].to_numpy())
    np.testing.assert_array_equal(got.labels, rows["label"].to_numpy())
    assert got.total_predicted == int((want["label"] > 0).sum())
    assert got.total_rejected == int((want["label"] == 0).sum())
    return got, want


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_classify_events_vs_jax(scene):
    _compare(SCENES[scene], DEFAULT_CONFIG)


def test_duplicate_index_rows_fall_together():
    got, _ = _compare(SCENES["duplicate_index"], DEFAULT_CONFIG)
    assert got.frame_numbers.tolist() == [51, 80]


@pytest.mark.parametrize("overrides", [
    {"angle_band_halfwidth": 60.0},
    {"false_angle_min_disp": 5.0},
    {"angle_band_halfwidth": 60.0, "false_angle_min_disp": 5.0},
])
def test_classify_events_opt_in_settings_vs_jax(overrides):
    cfg = dataclasses.replace(DEFAULT_CONFIG, **overrides)
    for events in SCENES.values():
        _compare(events, cfg)


def test_labels_dataframe_equals_jax_frame():
    events = SCENES["duplicate_index"] + SCENES["band"]
    want = jax_classify_events(events, DEFAULT_CONFIG)
    got = labels_dataframe(classify_events(events, DEFAULT_CONFIG), FPS)
    assert got.equals(want)
    assert list(got.index.names) == list(want.index.names)
