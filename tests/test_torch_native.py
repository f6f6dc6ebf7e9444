"""The port's native frame pump (swiftwatcher_tpu_torch/io/native.py) vs the
JAX package's (swiftwatcher_tpu/io/native.py): both built from the repo's
native/framepump.cpp, the port's into build/native/.  Every entry point
bit for bit on the same seeded inputs: the gray crop (also against the
port's numpy formula), the JPEG decode, the window decode to gray crops
with its failure flags, and the MJPG AVI reader.  Plus the build's
once-per-process guarantee under threads that need the library together."""

import sys
import threading

import cv2
import numpy as np
import pytest

from swiftwatcher_tpu.io import native as jax_native
from swiftwatcher_tpu_torch import build
from swiftwatcher_tpu_torch.io import native
from swiftwatcher_tpu_torch.io.synthetic import write_container
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host


@pytest.fixture(autouse=True)
def _need_both():
    if not (native.is_available() and jax_native.is_available()):
        pytest.skip("native toolchain unavailable (g++ or libjpeg)")


def _smooth(rng, shape):
    return cv2.GaussianBlur(rng.integers(0, 256, size=shape, dtype=np.uint8), (5, 5), 2)


def test_library_is_built_under_build_native():
    path = build.native_library_path("framepump", ("-ljpeg", "-lpthread"))
    assert path.parent == build.NATIVE_BUILD_DIR and path.is_file()
    assert path.parent.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("crop", [[(20, 10), (140, 100)], [(0, 0), (160, 120)],
                                  [(159, 119), (160, 120)], [(3, 0), (4, 120)]])
@pytest.mark.parametrize("n_threads", [1, 3])
def test_gray_crop_batch_vs_jax_and_numpy(rng, crop, n_threads):
    frames = rng.integers(0, 256, size=(7, 120, 160, 3), dtype=np.uint8)
    ours = native.gray_crop_batch(frames, crop, n_threads=n_threads)
    theirs = jax_native.gray_crop_batch(frames, crop, n_threads=n_threads)
    (x1, y1), (x2, y2) = crop
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, bgr_to_gray_host(frames[:, y1:y2, x1:x2]))
    out = np.zeros_like(ours)
    native.gray_crop_frames(list(frames), crop, out)
    np.testing.assert_array_equal(out, ours)


def test_gray_crop_checks_its_bounds_and_output(rng):
    frames = rng.integers(0, 256, size=(2, 40, 50, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.gray_crop_batch(frames, [(0, 0), (51, 40)])
    with pytest.raises(ValueError, match="outside"):
        native.gray_crop_batch(frames, [(-1, 0), (10, 10)])
    with pytest.raises(ValueError, match="out"):
        native.gray_crop_batch(frames, [(0, 0), (10, 10)], out=np.empty((2, 10, 9), np.uint8))


def test_decode_jpeg_bgr_vs_jax(rng):
    img = _smooth(rng, (64, 96, 3))
    enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])[1].tobytes()
    ours, theirs = native.decode_jpeg_bgr(enc), jax_native.decode_jpeg_bgr(enc)
    assert ours is not None and ours.shape == (64, 96, 3)
    np.testing.assert_array_equal(ours, theirs)
    assert native.decode_jpeg_bgr(b"not a jpeg") is None
    assert jax_native.decode_jpeg_bgr(b"not a jpeg") is None


def test_decode_window_gray_vs_jax(rng):
    H, W = 80, 120
    enc = [cv2.imencode(".jpg", _smooth(rng, (H, W, 3)), [cv2.IMWRITE_JPEG_QUALITY, 95])[1]
           .tobytes() for _ in range(6)]
    enc[2] = b"\xff\xd8 truncated"          # a payload that fails to decode
    enc[4] = b""                            # a null frame's empty payload
    crop = [(10, 5), (110, 75)]
    ours, ok = native.decode_window_gray(enc, H, W, crop, n_threads=2)
    theirs, ok_j = jax_native.decode_window_gray(enc, H, W, crop, n_threads=2)
    np.testing.assert_array_equal(ok, ok_j)
    assert ok.tolist() == [True, True, False, True, False, True]
    np.testing.assert_array_equal(ours, theirs)
    out = np.full((6, 70, 100), 7, np.uint8)
    native.decode_window_gray(enc, H, W, crop, out=out)
    np.testing.assert_array_equal(out, ours)


def _write_avi(path, frames, fourcc="MJPG"):
    assert write_container(path, frames, 25.0, fourcc)


def test_avi_reader_vs_jax(tmp_path, rng):
    frames = np.stack([_smooth(rng, (48, 64, 3)) for _ in range(9)])
    path = tmp_path / "clip.avi"
    _write_avi(path, frames)
    ours, theirs = native.AVIReader.open(path), jax_native.AVIReader.open(path)
    try:
        assert (ours.n_frames, ours.fps, ours.width, ours.height) == (
            theirs.n_frames, theirs.fps, theirs.width, theirs.height) == (9, 25.0, 64, 48)
        for _ in range(10):                 # one past the end: None from both
            a, b = ours.read(), theirs.read()
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert a is None
    finally:
        ours.close()
        theirs.close()
    assert ours.read() is None              # closed: no read


def test_avi_reader_refuses_other_files(tmp_path, rng):
    frames = np.stack([_smooth(rng, (48, 64, 3)) for _ in range(4)])
    ffv1 = tmp_path / "ffv1.avi"
    _write_avi(ffv1, frames, "FFV1")
    junk = tmp_path / "junk.avi"
    junk.write_bytes(b"RIFF" + bytes(200))
    for p in (ffv1, junk, tmp_path / "missing.avi"):
        assert native.AVIReader.open(p) is None
        assert jax_native.AVIReader.open(p) is None


def test_concurrent_first_use_builds_once(monkeypatch):
    """Threads that need a library first together get one build and one
    handle (the --parallel-videos case): more threads than cores, a short
    switch interval, and a compile that counts its calls."""
    compiles = []
    real = build._compile

    def counting(*a, **k):
        compiles.append(a[2])
        real(*a, **k)

    monkeypatch.setattr(build, "_compile", counting)
    key = ("native", "framepump")
    monkeypatch.delitem(build._loaded, key)
    monkeypatch.setattr(build, "native_library_path",
                        lambda name, libs, _real=build.native_library_path:
                        _real(name, libs).with_name(f"lib{name}-threads-test.so"))
    got, errors = [], []

    def worker():
        try:
            got.append(native._load())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        path = build.native_library_path("framepump", ("-ljpeg", "-lpthread"))
        path.unlink(missing_ok=True)
    assert not errors
    assert len(compiles) == 1
    assert len(got) == 32 and got[0] is not None and all(g is got[0] for g in got)
