"""The frames mode's gray crop (csrc/gray_crop.cpp through
io/native.py:gray_crop_frames), which needs g++ but no libjpeg: bit-equal
to ops/color.py:bgr_to_gray_host on random frames, whatever the threads,
the crop or where each frame lies; and WindowPrefetcher's frames mode,
which takes it with the frame pump unavailable, gives the numpy route's
batches and books one `prefetch_gray_crop` span a window."""

import dataclasses

import numpy as np
import pytest
import torch

from swiftwatcher_tpu_torch import build
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io import native
from swiftwatcher_tpu_torch.io.prefetch import WindowPrefetcher
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
from swiftwatcher_tpu_torch.utils.metrics import RunMetrics

CPU = torch.device("cpu")
H, W = 60, 80
CROPS = {
    "inner": [(10, 5), (50, 41)],
    "odd_width": [(3, 7), (10, 30)],
    "one_column": [(79, 0), (80, 60)],
    "bottom_right_edge": [(47, 33), (80, 60)],
    "whole_frame": [(0, 0), (80, 60)],
}


@pytest.fixture(autouse=True)
def _need_the_library():
    if not native.has_symbol("swt_gray_crop_frames"):
        pytest.skip("g++ unavailable: the gray crop library is not built")


def _frames(rng, n, h=H, w=W):
    return rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def _want(frames, crop):
    (x1, y1), (x2, y2) = crop
    return np.stack([bgr_to_gray_host(f[y1:y2, x1:x2]) for f in frames])


def test_library_is_built_under_build_native_without_libjpeg():
    path = build.native_library_path("gray_crop", ("-lpthread",))
    assert path.parent == build.NATIVE_BUILD_DIR and path.is_file()
    assert build.native_source("gray_crop").parent == build.CSRC
    assert "jpeglib.h" not in build.native_source("gray_crop").read_text()


@pytest.mark.parametrize("crop", sorted(CROPS))
@pytest.mark.parametrize("n", [1, 21])
@pytest.mark.parametrize("n_threads", [1, 3, 32])
def test_gray_crop_frames_is_bgr_to_gray_host(rng, crop, n, n_threads):
    frames = _frames(rng, n)
    out = np.full((n, *_want(frames[:1], CROPS[crop]).shape[1:]), 7, np.uint8)
    got = native.gray_crop_frames(list(frames), CROPS[crop], out, n_threads=n_threads)
    assert got is out
    np.testing.assert_array_equal(out, _want(frames, CROPS[crop]))


def test_threads_do_not_change_the_result(rng):
    frames = list(_frames(rng, 21, 120, 160))
    crop = [(13, 9), (140, 111)]
    outs = [native.gray_crop_frames(frames, crop, np.empty((21, 102, 127), np.uint8),
                                    n_threads=t) for t in (1, 2, 4, 8, 21)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_each_frame_is_cropped_where_it_lies(rng):
    """Frames of one window at their own addresses, of differing sizes,
    with rows wider than the frame (a view of a wider array) or pixels
    not packed B, G, R (a channel-reversed view, copied first)."""
    wide = _frames(rng, 1, H, W + 40)[0]
    frames = [_frames(rng, 1)[0], wide[:, 15:15 + W], _frames(rng, 1, H + 9, W + 3)[0],
              _frames(rng, 1)[0][:, :, ::-1], np.asfortranarray(_frames(rng, 1)[0])]
    crop = CROPS["inner"]
    out = native.gray_crop_frames(frames, crop, np.empty((5, 36, 40), np.uint8))
    np.testing.assert_array_equal(out, _want(frames, crop))


def test_gray_crop_frames_checks_its_bounds_and_output(rng):
    frames = list(_frames(rng, 2))
    with pytest.raises(ValueError, match="outside"):
        native.gray_crop_frames(frames, [(0, 0), (81, 60)], np.empty((2, 60, 81), np.uint8))
    with pytest.raises(ValueError, match="outside"):
        native.gray_crop_frames(frames + [_frames(rng, 1, H - 1)[0]], CROPS["whole_frame"],
                                np.empty((3, 60, 80), np.uint8))
    with pytest.raises(ValueError, match="out"):
        native.gray_crop_frames(frames, CROPS["inner"], np.empty((2, 36, 39), np.uint8))


def _batches(frames, crop, monkeypatch, route, metrics=None, batch_windows=2):
    """Every batch (payload, frame numbers) of WindowPrefetcher's frames
    mode over `frames` with the frame pump unavailable, on `route`
    ("library" or "numpy"), and the number of gray_crop_frames calls."""
    calls = []
    real = native.gray_crop_frames

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(native, "is_available", lambda: False)
    monkeypatch.setattr(native, "gray_crop_frames", spy)
    if route == "numpy":
        monkeypatch.setattr(native, "has_symbol", lambda name: False)
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=batch_windows, prefetch_depth=2)
    pf = WindowPrefetcher(ArraySource(frames), crop, CPU, cfg, keep_frames=True,
                          metrics=metrics)
    out = []
    try:
        while (b := pf.next()) is not None:
            payload, wins, _ = b
            assert all(w[0] is not None for w in wins)
            out.append((payload.clone(), [w[1] for w in wins]))
    finally:
        pf.close()
    assert pf.mode == "frames"
    monkeypatch.undo()
    return out, calls


@pytest.mark.parametrize("crop", [[(8, 6), (71, 49)], [(60, 40), (95, 70)]],
                         ids=["inside", "past_the_edge"])
def test_prefetcher_frames_mode_takes_the_library_without_the_frame_pump(rng, crop,
                                                                          monkeypatch):
    """Five windows in batches of two (the last padded); a crop past the
    frame's edge keeps numpy's python-slice semantics."""
    frames = _frames(rng, 105)
    ours, calls = _batches(frames, crop, monkeypatch, "library")
    theirs, none = _batches(frames, crop, monkeypatch, "numpy")
    inside = crop[1] == (71, 49)
    assert calls == ([21] * 5 if inside else []) and none == []
    assert len(ours) == len(theirs) == 3
    for (a, na), (b, nb) in zip(ours, theirs):
        assert na == nb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if inside:
        (x1, y1), (x2, y2) = crop
        want = _want(frames, crop).reshape(5, 21, y2 - y1, x2 - x1)
        np.testing.assert_array_equal(ours[0][0].numpy(), want[:2])
        np.testing.assert_array_equal(ours[2][0].numpy(), want[[4, 4]])


@pytest.mark.parametrize("route", ["library", "numpy"])
def test_prefetch_gray_crop_span_counts_once_a_window(rng, route, monkeypatch):
    frames = _frames(rng, 105)
    run = RunMetrics()
    batches, _ = _batches(frames, [(8, 6), (71, 49)], monkeypatch, route, metrics=run)
    assert run.counters["prefetch_gray_crop"] == 5
    assert run.counters["prefetch_read"] == len(batches) == 3
    assert 0.0 <= run.stage_seconds["prefetch_gray_crop"] <= run.stage_seconds["prefetch_read"]
