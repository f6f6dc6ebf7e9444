"""The probe records what the timed path produced, and puts the program's
names back after."""

import numpy as np
import torch

import swiftwatcher_tpu_torch.pipeline.runner as runner
import swiftwatcher_tpu_torch.pipeline.window as window
from swtbench import traffic
from swtbench.probe import Probe
from swtbench.reference.localize import regions
from swtbench.spec import HERE, load_json
from swiftwatcher_tpu_torch.config import config_with_overrides


def _batch(seed=5, B=2, T=21):
    H, W = 240, 320
    corners = traffic.scene_corners(H, W)
    p = load_json(HERE / "configs" / "accuracy-1080p.json")["pipeline"]
    crop, _ = regions(corners, p)
    clip = traffic.generate(dict(load_json(HERE / "traffic" / "jitter.json"), blocks=1),
                            seed, H, W, crop)
    (x1, y1), (x2, y2) = clip.crop
    pose = torch.from_numpy(traffic.gray_of_bgr(clip.first_frame[y1:y2, x1:x2]))
    gray = torch.from_numpy(clip.crops[:B * T].reshape(B, T, *clip.crops.shape[1:]))
    return gray, pose


def test_the_probe_records_each_batch_and_restores_the_names():
    names = (runner.localize_windows_gray, window.stabilize_window, runner.RunMetrics)
    cfg = config_with_overrides(["stabilize_max_shift=3"])
    gray, pose = _batch()
    with Probe("cpu", slots=2, windows_per_batch=2, window_frames=21) as probe:
        assert runner.localize_windows_gray is not names[0]
        tables = [runner.localize_windows_gray(g, cfg, stab_ref=pose)[0]
                  for g in (gray, gray.flip(0), gray)]
        assert isinstance(runner.RunMetrics(), names[2]) and probe.metrics is not None
    assert (runner.localize_windows_gray, window.stabilize_window, runner.RunMetrics) == names
    assert probe.n_tables == 3                    # the third went past the slots
    segments, shifts = probe.frames(10_000)
    assert len(segments) == 2 * 2 * 21
    for i, table in enumerate(tables[:2]):
        for f in range(42):
            b, t = divmod(f, 21)
            valid = table.valid[b, t].numpy()
            area = table.area[b, t].numpy()[valid].astype(float)
            want = list(zip(table.sum_y[b, t].numpy()[valid] / area,
                            table.sum_x[b, t].numpy()[valid] / area))
            assert segments[i * 42 + f] == want
    _, want_shifts = names[1](gray, 3, pose)
    np.testing.assert_array_equal(shifts[:42], want_shifts.reshape(-1, 2).numpy())
    assert np.abs(shifts).sum() > 0 and sum(map(len, segments)) > 0
    assert len(probe.frames(50)[0]) == 50


def test_without_stabilisation_no_shifts_are_recorded():
    gray, _ = _batch()
    with Probe("cpu", slots=1, windows_per_batch=2, window_frames=21) as probe:
        runner.localize_windows_gray(gray, config_with_overrides([]))
    assert probe.frames(42)[1] is None
