"""The served stream against the container source's gray-crop contract."""

import time

import numpy as np
import pytest

from swtbench import traffic
from swtbench.reference.localize import regions
from swtbench.source import StreamSource
from swtbench.spec import load_json, HERE


def _traffic(name):
    return load_json(HERE / "traffic" / f"{name}.json")


P = load_json(HERE / "configs" / "count-1080p.json")["pipeline"]


def _clip(H=240, W=320, seed=3):
    params = dict(_traffic("dusk"), blocks=1)
    crop, _ = regions(traffic.scene_corners(H, W), P)
    return traffic.generate(params, seed, H, W, crop)


def test_first_crop_is_the_gray_of_the_first_frame():
    clip = _clip()
    (x1, y1), (x2, y2) = clip.crop
    assert np.array_equal(clip.crops[0], traffic.gray_of_bgr(clip.first_frame[y1:y2, x1:x2]))


def test_windows_loop_the_clip_with_null_frames_and_the_inclusive_end():
    clip = _clip()
    N = len(clip.crops)
    src = StreamSource(clip, max_frames=N + 5)
    assert src.read_frame(0, increment=False) is clip.first_frame
    assert not src.enable_gray_crop_stream([(0, 0), (8, 8)])
    assert src.enable_gray_crop_stream(clip.crop)
    out, numbers, stamps = src.get_gray_crop_window(N)
    assert numbers == list(range(N)) and stamps == numbers
    assert np.array_equal(out, clip.crops)
    out, numbers, _ = src.get_gray_crop_window(8)
    # frames N..N+4 loop the clip; N+5 is the inclusive end: the last good
    # crop again, one read error; past it null frames
    assert numbers == [N, N + 1, N + 2, N + 3, N + 4, N + 5, -1, -1]
    assert np.array_equal(out[:5], clip.crops[:5])
    assert np.array_equal(out[5], clip.crops[4])
    assert not out[6:].any()
    assert src.read_errors == 1 and src.frames_read == N + 5


def test_read_frame_serves_frame_zero_only():
    src = StreamSource(_clip(), max_frames=100)
    with pytest.raises(RuntimeError):
        src.read_frame(1, increment=False)


def test_the_deadline_ends_the_feed_at_a_window():
    clip = _clip()
    src = StreamSource(clip, max_frames=10**6)
    src.enable_gray_crop_stream(clip.crop)
    src.get_gray_crop_window(21)
    assert src.total_frames == 10**6
    src.deadline = time.perf_counter() - 1.0
    src.get_gray_crop_window(21)
    assert src.total_frames == src.end_frame == 42 == src.next_frame_number


def test_same_seed_same_clip_and_seeds_change_only_noise():
    a, b, c = _clip(seed=5), _clip(seed=5), _clip(seed=6)
    assert np.array_equal(a.crops, b.crops) and np.array_equal(a.first_frame, b.first_frame)
    assert not np.array_equal(a.crops, c.crops)
    # the same actors at the same places: the seeds differ by noise and sky
    # tone (a few gray levels), never by a dot (120)
    assert np.abs(a.crops.astype(int) - c.crops.astype(int)).max() < 20


@pytest.mark.parametrize("name", ["dusk", "jitter"])
def test_every_traffic_makes_whole_windows(name):
    params = _traffic(name)
    assert params["block_frames"] % 21 == 0
    clip = traffic.generate(dict(params, blocks=1), 9, 240, 320,
                            regions(traffic.scene_corners(240, 320), P)[0])
    assert clip.crops.shape[0] == params["block_frames"]


def test_the_generators_other_parameters_change_the_frames():
    base = {"scene": "hard", "block_frames": 42, "blocks": 1,
            "actors": {"n_entering": 2, "n_flyby": 1, "n_vanishing": 1, "n_crossing": 1}}
    crop, _ = regions(traffic.scene_corners(240, 320), P)
    plain = traffic.generate(base, 4, 240, 320, crop).crops
    (x1, y1), _ = crop
    cp = {"t0": 30, "t1": 32, "row": y1 + 4, "x0": x1 + 2, "step": 8, "size": 16, "amp": 120}
    for extra in ({"actors": dict(base["actors"], occluder=True, jitter=1)},
                  {"motion_blur": 0.5}, {"flicker": 0.1}, {"brightness_drift": 0.5},
                  {"close_pass": cp}):
        clip = traffic.generate(dict(base, **extra), 4, 240, 320, crop)
        assert clip.crops.shape == plain.shape
        assert not np.array_equal(clip.crops, plain), extra
    # the close pass darkens its block by the amplitude
    assert (plain[30, 4:20, 2:18].astype(int) - clip.crops[30, 4:20, 2:18] > 100).all()
