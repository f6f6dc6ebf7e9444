"""The port's chunk-parallel decoder (swiftwatcher_tpu_torch/io/
parallel_decode.py) vs the JAX package's (swiftwatcher_tpu/io/
parallel_decode.py) on the same MP4: the seek probe (also against a
container whose deep seeks land by origin), the frames of fixed and
keyframe-aligned chunks, restarts, a worker whose read fails without
advancing, the libav gray-crop workers, and the buffer's bounds after a
restart or a start inside a long chunk."""

import time

import cv2
import numpy as np
import pytest

from swiftwatcher_tpu.io import parallel_decode as jax_pd
from swiftwatcher_tpu_torch.io import native_av
from swiftwatcher_tpu_torch.io.parallel_decode import (
    ParallelDecoder,
    gray_crop_worker_factory,
    probe_seek_accuracy,
)
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container

_REAL_CAPTURE = cv2.VideoCapture


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1)
    p = tmp_path_factory.mktemp("torch_pdec") / "clip.mp4"
    assert write_container(p, video.frames, video.fps, "mp4v")
    cap = _REAL_CAPTURE(str(p))
    seq = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        seq.append(f)
    cap.release()
    return p, seq


def _keyframes(p):
    rd = native_av.AVReader.open(p)
    if rd is None:
        return None
    try:
        kfs = rd.keyframes()
        return None if kfs is None else [int(k) for k in kfs]
    finally:
        rd.close()


def test_probe_seek_accuracy_vs_jax(mp4):
    p, _ = mp4
    for total in (None, 63):
        assert probe_seek_accuracy(p, total) == jax_pd.probe_seek_accuracy(p, total) is True


class _SloppyDeepSeek:
    """A capture whose seeks past frame 20 snap to even frames."""

    def __init__(self, path):
        self._c = _REAL_CAPTURE(str(path))

    def __getattr__(self, name):
        return getattr(self._c, name)

    def set(self, prop, val):
        if prop == cv2.CAP_PROP_POS_FRAMES and val > 20:
            val = val - (val % 2)
        return self._c.set(prop, val)


def test_probe_rejects_origin_dependent_seek_as_jax(mp4, monkeypatch):
    p, _ = mp4
    monkeypatch.setattr(cv2, "VideoCapture", _SloppyDeepSeek)
    assert probe_seek_accuracy(p) == jax_pd.probe_seek_accuracy(p) is True
    assert probe_seek_accuracy(p, 63) == jax_pd.probe_seek_accuracy(p, 63) is False


@pytest.mark.parametrize("workers, chunk, max_ahead, aligned", [
    (1, 8, 64, False), (3, 5, 17, False), (4, 16, 64, False), (3, 8, 64, True),
])
def test_decoder_vs_jax_and_sequential(mp4, workers, chunk, max_ahead, aligned):
    p, seq = mp4
    kfs = _keyframes(p) if aligned else None
    if aligned and kfs is None:
        pytest.skip("no libav keyframe index on this host")
    ours = ParallelDecoder(p, len(seq), n_workers=workers, chunk=chunk, max_ahead=max_ahead,
                           boundaries=kfs)
    theirs = jax_pd.ParallelDecoder(p, len(seq), n_workers=workers, chunk=chunk,
                                    max_ahead=max_ahead, boundaries=kfs)
    try:
        np.testing.assert_array_equal(ours._bounds, theirs._bounds)
        if aligned:
            starts = [int(b) for b in ours._bounds[:-1]]
            assert all(s in kfs for s in starts)
            assert all(b - a >= chunk for a, b in zip(starts, starts[1:]))
        for i, ref in enumerate(seq):
            a, b = ours.get(i), theirs.get(i)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, ref)
        assert ours.get(len(seq)) is None and theirs.get(len(seq)) is None
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("jumps", [[40], [40, 3], [62, 0, 33]])
def test_restart_vs_jax(mp4, jumps):
    p, seq = mp4
    ours = ParallelDecoder(p, len(seq), n_workers=2, chunk=4)
    theirs = jax_pd.ParallelDecoder(p, len(seq), n_workers=2, chunk=4)
    try:
        np.testing.assert_array_equal(ours.get(0), theirs.get(0))
        for j in jumps:
            ours.restart(j)
            theirs.restart(j)
            for i in range(j, min(j + 6, len(seq))):
                a, b = ours.get(i), theirs.get(i)
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, seq[i])
    finally:
        ours.close()
        theirs.close()


def test_worker_realigns_after_failed_read_as_jax(mp4, monkeypatch):
    """A failed read does not advance cv2's cursor: the rest of its chunk
    is published as failures and the next chunk seeks again, in both."""
    p, seq = mp4
    failed = set()

    class OneFailNoAdvance(_SloppyDeepSeek):
        def set(self, prop, val):
            return self._c.set(prop, val)

        def read(self):
            pos = int(self._c.get(cv2.CAP_PROP_POS_FRAMES))
            if pos == 20 and id(self) not in failed and len(failed) < 2:
                failed.add(id(self))
                return False, None
            return self._c.read()

    monkeypatch.setattr(cv2, "VideoCapture", OneFailNoAdvance)
    got = {}
    for name, cls in (("ours", ParallelDecoder), ("theirs", jax_pd.ParallelDecoder)):
        dec = cls(p, len(seq), n_workers=1, chunk=8)
        try:
            got[name] = [dec.get(i) for i in range(len(seq))]
        finally:
            dec.close()
    for i in range(len(seq)):
        a, b = got["ours"][i], got["theirs"][i]
        if 20 <= i < 24:
            assert a is None and b is None, i
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, seq[i])


@pytest.mark.parametrize("crop", [[(10, 20), (130, 100)], [(0, 0), (320, 240)]])
def test_gray_crop_workers_vs_jax(mp4, crop):
    p, seq = mp4
    if not native_av.is_available():
        pytest.skip("no libav on this host")
    kfs = _keyframes(p)
    ours = ParallelDecoder(p, len(seq), n_workers=3, chunk=8, boundaries=kfs,
                           worker_factory=gray_crop_worker_factory(crop))
    theirs = jax_pd.ParallelDecoder(p, len(seq), n_workers=3, chunk=8, boundaries=kfs,
                                    worker_factory=jax_pd.gray_crop_worker_factory(crop))
    (x1, y1), (x2, y2) = crop
    try:
        for i, ref in enumerate(seq):
            a, b = ours.get(i), theirs.get(i)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, cv2.cvtColor(ref, cv2.COLOR_BGR2GRAY)[y1:y2, x1:x2])
        ours.restart(41)
        np.testing.assert_array_equal(
            ours.get(41), cv2.cvtColor(seq[41], cv2.COLOR_BGR2GRAY)[y1:y2, x1:x2])
    finally:
        ours.close()
        theirs.close()


def test_a_worker_that_cannot_open_publishes_failures():
    def broken(path):
        raise RuntimeError("no decoder")

    dec = ParallelDecoder("fake", 20, n_workers=2, chunk=4, worker_factory=broken)
    try:
        assert [dec.get(i) for i in range(20)] == [None] * 20
    finally:
        dec.close()


class _CountingWorker:
    """Frame n decodes to array([n])."""

    def __init__(self, path):
        self.pos = 0

    def seek(self, pos):
        self.pos = pos
        return True

    def read(self):
        f = np.array([self.pos], np.int64)
        self.pos += 1
        return f

    def close(self):
        pass


def test_restart_into_a_long_chunk_stores_no_prefix():
    dec = ParallelDecoder("fake", 200, n_workers=2, chunk=8, worker_factory=_CountingWorker,
                          boundaries=[0, 100])
    try:
        for i in range(3):
            assert int(dec.get(i)[0]) == i
        dec.restart(60)
        for i in range(60, 100):
            assert int(dec.get(i)[0]) == i
        deadline = time.time() + 5
        while time.time() < deadline:
            with dec._lock:
                stale = [k for k in dec._frames if k < 59]
            if not stale:
                break
            time.sleep(0.05)
        assert not stale, sorted(stale)[:10]
        assert int(dec.get(100)[0]) == 100
    finally:
        dec.close()
    assert not any(t.is_alive() for t in dec._threads)


def test_start_inside_a_long_chunk_stores_no_prefix():
    dec = ParallelDecoder("fake", 200, n_workers=2, chunk=8, start=70,
                          worker_factory=_CountingWorker, boundaries=[0, 100])
    try:
        for i in range(70, 110):
            assert int(dec.get(i)[0]) == i
        with dec._lock:
            assert not [k for k in dec._frames if k < 69]
    finally:
        dec.close()
