"""The port's libav reader (swiftwatcher_tpu_torch/io/native_av.py) vs the
JAX package's (swiftwatcher_tpu/io/native_av.py), both built from the
repo's native/avpump.cpp, on MPEG-4 (cv2's mp4v) and H.264 (the system's
libx264, through each package's write_test_video) MP4s: every frame, the
keyframe index, seeks, the gray-crop stream, the null decode, the three
probes, and the test-video writers.  A codec the host cannot encode skips,
as in the JAX package's tests."""

import cv2
import numpy as np
import pytest

from swiftwatcher_tpu.io import native_av as jax_av
from swiftwatcher_tpu_torch.io import native_av
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host


@pytest.fixture(autouse=True)
def _need_both():
    if not (native_av.is_available() and jax_av.is_available()):
        pytest.skip("libav native decoder unavailable")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{codec: (path, frames)} for every codec this host can encode."""
    if not native_av.is_available():
        return {}
    video = make_video(seed=3, n_frames=48, n_entering=2, n_crossing=1)
    d = tmp_path_factory.mktemp("torch_avdec")
    out = {}
    p = d / "clip_mp4v.mp4"
    assert write_container(p, video.frames, video.fps, "mp4v")
    out["mp4v"] = (p, video.frames)
    p = d / "clip_h264.mp4"
    if native_av.write_test_video(p, video.frames, fps=video.fps, codec="libx264"):
        out["h264"] = (p, video.frames)
    return out


@pytest.fixture(params=["mp4v", "h264"])
def clip(request, clips):
    if request.param not in clips:
        pytest.skip(f"no encoder for {request.param} on this host")
    return clips[request.param]


def _open_both(path):
    return native_av.AVReader.open(path), jax_av.AVReader.open(path)


def test_every_frame_vs_jax_and_cv2(clip):
    path, frames = clip
    ours, theirs = _open_both(path)
    cap = cv2.VideoCapture(str(path))
    try:
        assert (ours.n_frames, ours.fps, ours.width, ours.height) == (
            theirs.n_frames, theirs.fps, theirs.width, theirs.height)
        assert ours.n_frames == len(frames)
        for _ in range(len(frames) + 1):    # one past the end: None from both
            a, b = ours.read(), theirs.read()
            ok, ref = cap.read()
            assert (a is None) == (b is None) == (not ok)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, ref)
    finally:
        ours.close()
        theirs.close()
        cap.release()
    assert ours.read() is None and ours.read_gray_crop([(0, 0), (4, 4)]) is None


def test_keyframes_and_null_decode_vs_jax(clip):
    path, frames = clip
    ours, theirs = _open_both(path)
    try:
        kf = ours.keyframes()
        np.testing.assert_array_equal(kf, theirs.keyframes())
        assert kf[0] == 0 and (np.diff(kf) > 0).all()
        for rd in (ours, theirs):
            n = 0
            while rd.read_null():
                n += 1
            assert n == len(frames)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("targets", [[8, 3, 40, 0], [47, 46, 12], [48, 5]])
def test_seek_vs_jax(clip, targets):
    path, _ = clip
    ours, theirs = _open_both(path)
    try:
        for t in targets:
            a, b = ours.seek(t), theirs.seek(t)
            assert a == b
            if a:
                np.testing.assert_array_equal(ours.read(), theirs.read())
    finally:
        ours.close()
        theirs.close()
    assert native_av.probe_native_seek(path) == jax_av.probe_native_seek(path) is True


@pytest.mark.parametrize("crop", [[(10, 20), (130, 100)], [(0, 0), (320, 240)],
                                  [(301, 7), (319, 239)]])
def test_gray_crop_stream_vs_jax_and_bgr(clip, crop):
    path, frames = clip
    ours, theirs = _open_both(path)
    full = native_av.AVReader.open(path)
    (x1, y1), (x2, y2) = crop
    try:
        for _ in range(len(frames) + 1):
            a, b, f = ours.read_gray_crop(crop), theirs.read_gray_crop(crop), full.read()
            assert (a is None) == (b is None) == (f is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, bgr_to_gray_host(f[y1:y2, x1:x2]))
    finally:
        for rd in (ours, theirs, full):
            rd.close()
    assert native_av.probe_gray_crop_parity(path, crop) == jax_av.probe_gray_crop_parity(
        path, crop) is True


def test_bgr_parity_probe_vs_jax(clip, tmp_path):
    path, _ = clip
    ours, theirs = native_av.probe_bgr_parity(path), jax_av.probe_bgr_parity(path)
    assert ours is not None and theirs is not None
    np.testing.assert_array_equal(ours.read(), theirs.read())   # both at frame 0
    ours.close()
    theirs.close()
    bogus = tmp_path / "noise.mp4"
    bogus.write_bytes(b"\x00" * 4096)
    assert native_av.probe_bgr_parity(bogus) is None and jax_av.probe_bgr_parity(bogus) is None
    assert not native_av.probe_native_seek(bogus)
    assert not native_av.probe_gray_crop_parity(bogus, [(0, 0), (4, 4)])


def _decode_all(path):
    rd = native_av.AVReader.open(path)
    try:
        out = []
        while (f := rd.read()) is not None:
            out.append(f)
        return out, rd.fps
    finally:
        rd.close()


@pytest.mark.parametrize("codec", ["mpeg4", "libx264"])
def test_write_test_video_vs_jax(tmp_path, codec):
    frames = make_video(seed=5, n_frames=20, H=96, W=128, n_entering=1).frames
    ours, theirs = tmp_path / "ours.mp4", tmp_path / "theirs.mp4"
    ok = native_av.write_test_video(ours, frames, 25.0, codec)
    assert ok == jax_av.write_test_video(theirs, frames, 25.0, codec)
    if not ok:
        pytest.skip(f"no {codec} encoder on this host")
    a, fa = _decode_all(ours)
    b, fb = _decode_all(theirs)
    assert len(a) == len(b) == 20 and fa == fb == 25.0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_write_test_video_vfr_vs_jax(tmp_path):
    frames = make_video(seed=6, n_frames=12, H=64, W=96, n_entering=1).frames
    pts = np.cumsum([0.0] + [0.04, 0.05] * 5 + [0.04])
    ours, theirs = tmp_path / "ours.mp4", tmp_path / "theirs.mp4"
    ok = native_av.write_test_video_vfr(ours, frames, pts)
    assert ok == jax_av.write_test_video_vfr(theirs, frames, pts)
    if not ok:
        pytest.skip("no libx264 encoder on this host")
    a, fa = _decode_all(ours)
    b, fb = _decode_all(theirs)
    assert len(a) == len(b) == 12 and fa == fb
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="ascending"):
        native_av.write_test_video_vfr(ours, frames, pts[::-1])
