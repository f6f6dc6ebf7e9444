"""The plain reference against the port on small scenes (CPU).

The port runs its float64 solve here, so that the two agree to rounding;
the timed path's float32 solve is held to the reference by the runs
themselves (swtbench/compare.py)."""

import numpy as np
import pytest
import torch

from swtbench import traffic
from swtbench.reference import localize, track
from swtbench.spec import HERE, load_json
from swiftwatcher_tpu_torch.config import config_with_overrides
from swiftwatcher_tpu_torch.ops.stabilize import stabilize_window
from swiftwatcher_tpu_torch.pipeline.events import classify_events
from swiftwatcher_tpu_torch.pipeline.tracking import SegmentTracker
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

CONFIGS = ["count-1080p", "accuracy-1080p"]


def _setup(config, scene, seed=21, H=240, W=320):
    p = load_json(HERE / "configs" / f"{config}.json")["pipeline"]
    corners = traffic.scene_corners(H, W)
    crop, _ = localize.regions(corners, p)
    clip = traffic.generate(dict(load_json(HERE / "traffic" / f"{scene}.json"), blocks=1), seed, H, W, crop)
    return p, corners, clip


@pytest.mark.parametrize("config,scene", [("count-1080p", "dusk"), ("accuracy-1080p", "jitter")])
def test_segments_equal_the_ports_tables(config, scene):
    p, corners, clip = _setup(config, scene)
    cfg = config_with_overrides(["rpca_dtype=float64", f"stabilize_max_shift={p['stabilize_max_shift']}"])
    T = p["window_size"]
    windows = torch.from_numpy(clip.crops.reshape(-1, T, *clip.crops.shape[1:]))
    (x1, y1), (x2, y2) = clip.crop
    pose = torch.from_numpy(traffic.gray_of_bgr(clip.first_frame[y1:y2, x1:x2]))
    table, iters = localize_windows_gray(windows, cfg, stab_ref=pose if p["stabilize_max_shift"] else None)
    ref_windows = windows
    if p["stabilize_max_shift"]:
        ref_windows, shifts = localize.stabilize(windows, p["stabilize_max_shift"], pose)
        port_aligned, port_shifts = stabilize_window(windows, p["stabilize_max_shift"], pose)
        assert torch.equal(ref_windows, port_aligned) and torch.equal(shifts, port_shifts)
        assert shifts.abs().sum() > 0
    motion, ref_iters = localize.motion(ref_windows, p)
    assert np.abs(ref_iters - iters.numpy()).max() <= 1
    n_segments = 0
    for u in range(windows.shape[0]):
        for t in range(T):
            ours = localize.segments(motion[u, t], p)
            valid = table.valid[u, t].numpy()
            area = table.area[u, t].numpy()[valid].astype(float)
            theirs = np.stack([table.sum_y[u, t].numpy()[valid] / area,
                               table.sum_x[u, t].numpy()[valid] / area], 1)
            assert len(ours) == len(theirs)
            if ours:
                np.testing.assert_allclose(np.array(ours), theirs, atol=1e-6)
            n_segments += len(ours)
    assert n_segments > 10


@pytest.mark.parametrize("config", CONFIGS)
def test_tracker_and_labels_equal_the_ports(config):
    p = load_json(HERE / "configs" / f"{config}.json")["pipeline"]
    cfg = config_with_overrides([f"angle_band_halfwidth={p['angle_band_halfwidth']}",
                                 f"false_angle_min_disp={p['false_angle_min_disp']}"])
    rng = np.random.default_rng(4)
    roi = np.zeros((80, 120), np.uint8)
    roi[50:, 40:80] = 255
    ours, theirs = track.Tracker(roi, p), SegmentTracker(roi, cfg)
    for fn in range(3000):
        cents = [(float(y), float(x)) for y, x in rng.uniform((0, 0), (79, 119), (rng.integers(0, 4), 2))]
        ours.step(cents, fn)
        theirs.step(cents, fn, fn)
    got = [(e.first_centroid, e.last_centroid, e.frame_number) for e in theirs.events]
    assert ours.events == got and len(got) > 50
    c = classify_events(theirs.events, cfg)
    assert track.labels(ours.events, p) == (c.total_predicted, c.total_rejected)
