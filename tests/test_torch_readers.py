"""The port's frame sources (swiftwatcher_tpu_torch/io/source.py) and
prefetcher vs the JAX package's (swiftwatcher_tpu/io/readers.py,
io/prefetch.py) on the same files.

  * HDF5Source: round trip, an empty slot, the inclusive end, --start,
    corrupt payloads, the encoded windows and the error without h5py;
  * VideoFileSource on an MJPG AVI and an MPEG-4 MP4, on every backend
    that engages here (native, parallel, av, cv2): which one `auto` takes,
    its frames, its seekability, its gray-crop windows, and the errors of
    a backend asked for where it cannot engage;
  * WindowPrefetcher's three paths (frames, gray-crop stream, encoded JPEG)
    against the JAX prefetcher's batches;
  * run_video on each backend: the six CSVs byte-equal to the JAX
    package's run_video on the same file, and a checkpoint resume on the
    seekable backends equal to the full run.

Comparisons are exact: frames, gray crops and CSVs are bytes."""

import dataclasses
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io import readers as jax_readers
from swiftwatcher_tpu.io.prefetch import WindowPrefetcher as JaxPrefetcher
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
from swiftwatcher_tpu_torch.io import native, native_av
from swiftwatcher_tpu_torch.io.prefetch import WindowPrefetcher
from swiftwatcher_tpu_torch.io.source import (
    ArraySource,
    HDF5Source,
    VideoFileSource,
    open_source,
)
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")
WORKERS = 2  # decode workers: the suite runs in several processes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_runner)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def video():
    return make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)


def _write(path, frames, fourcc, fps=30.0):
    assert write_container(path, frames, fps, fourcc)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory, video):
    d = tmp_path_factory.mktemp("torch_readers")
    return {"avi": _write(d / "clip.avi", video.frames, "MJPG"),
            "mp4": _write(d / "clip.mp4", video.frames, "mp4v")}


# the backends that engage on each file where their libraries are built
BACKENDS = [("avi", "native"), ("avi", "parallel"), ("avi", "cv2"),
            ("mp4", "parallel"), ("mp4", "av"), ("mp4", "cv2")]


def _skip_without(backend):
    if backend == "native" and not native.is_available():
        pytest.skip("no native frame pump on this host")
    if backend == "av" and not native_av.is_available():
        pytest.skip("no libav on this host")


def _write_h5(path, payloads, fps=30.0, vlen=False, n=None):
    with h5py.File(path, "w") as fh:
        if vlen:
            d = fh.create_dataset("VideoFrames", (n or len(payloads),),
                                  dtype=h5py.vlen_dtype(np.uint8))
            for i, p in enumerate(payloads):
                if p is not None:
                    d[i] = np.frombuffer(p, np.uint8)
        else:
            maxlen = max(len(p) for p in payloads)
            data = np.zeros((len(payloads), maxlen), np.uint8)
            for i, p in enumerate(payloads):
                data[i, : len(p)] = np.frombuffer(p, np.uint8)
            fh.create_dataset("VideoFrames", data=data)
        fh.attrs["CAP_PROP_FPS"] = fps
        fh.attrs["CAP_PROP_FRAME_COUNT"] = n or len(payloads)
    return path


def _png(frames):
    return [cv2.imencode(".png", f)[1].tobytes() for f in frames]


def _jpg(frames, q=95):
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes() for f in frames]


def _walk(src, n):
    frames, numbers = [], []
    for _ in range(n):
        f, num, _ = src.get_frame()
        frames.append(None if f is None else np.array(f))
        numbers.append(num)
    return frames, numbers


def _same_frames(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("start, end", [(0, 0), (2, 5), (0, 4)])
def test_hdf5_round_trip_vs_jax(tmp_path, start, end):
    frames = make_video(seed=1, n_frames=6, H=40, W=56, n_entering=0, n_crossing=0).frames
    p = _write_h5(tmp_path / "clip.h5", _png(frames))
    ours, theirs = HDF5Source(p, start, end), jax_readers.HDF5Source(p, start, end)
    assert (ours.fps, ours.start_frame, ours.end_frame, ours.total_frames) == (
        theirs.fps, theirs.start_frame, theirs.end_frame, theirs.total_frames)
    a, na = _walk(ours, 9 - start)
    b, nb = _walk(theirs, 9 - start)
    assert na == nb
    _same_frames(a, b)
    last = end if end else 6
    # inclusive end: the read at index `last` substitutes frame last - 1
    assert na[: last - start + 1] == list(range(start, last + 1))
    np.testing.assert_array_equal(a[last - start], frames[last - 1] if last == 6 else frames[last])
    assert (ours.frames_read, ours.read_errors) == (theirs.frames_read, theirs.read_errors)
    ours.close()


def test_hdf5_empty_slot_and_corrupt_payload_vs_jax(tmp_path):
    frames = make_video(seed=2, n_frames=6, H=40, W=56, n_entering=0, n_crossing=0).frames
    payloads = _png(frames)
    payloads[3] = None                      # an unwritten slot
    payloads[4] = b"\x89PNG corrupt"        # cv2.imdecode fails
    p = _write_h5(tmp_path / "holes.h5", payloads, vlen=True)
    ours, theirs = HDF5Source(p), jax_readers.HDF5Source(p)
    a, na = _walk(ours, 8)
    b, nb = _walk(theirs, 8)
    assert na == nb
    _same_frames(a, b)
    np.testing.assert_array_equal(a[3], frames[2])
    assert ours.read_errors == theirs.read_errors == 3    # slots 3, 4 and the end
    for fn in range(7):
        assert ours.peek_encoded(fn) == theirs.peek_encoded(fn)
    assert ours.peek_encoded(3) is None and ours.peek_encoded(6) is None


def test_hdf5_encoded_windows_vs_jax(tmp_path):
    frames = make_video(seed=2, n_frames=6, H=40, W=56, n_entering=0, n_crossing=0).frames
    payloads = _jpg(frames)
    payloads[0] = None                      # a hole before any good payload
    payloads[3] = None
    p = _write_h5(tmp_path / "holes.h5", payloads, vlen=True)
    ours, theirs = HDF5Source(p), jax_readers.HDF5Source(p)
    windows = []
    for n in (4, 5):                        # frames 0-3, then 4, 5, the end and nulls
        a, na, sa = ours.get_encoded_window(n)
        b, nb, _ = theirs.get_encoded_window(n)
        assert a == b and na == nb
        assert sa == na                     # the port's stamps are frame numbers
        windows.append(a)
    assert windows[0][0] is None                 # no good payload yet: stays None
    assert windows[0][3] == payloads[2]          # the hole reuses the last good one
    assert windows[1][2] == payloads[5] and windows[1][3:] == [None, None]
    assert (ours.frames_read, ours.read_errors) == (theirs.frames_read, theirs.read_errors)


def test_hdf5_needs_its_attrs(tmp_path):
    p = tmp_path / "bare.h5"
    with h5py.File(p, "w") as fh:
        fh.create_dataset("VideoFrames", data=np.zeros((2, 4), np.uint8))
    with pytest.raises(RuntimeError, match="CAP_PROP_FPS"):
        HDF5Source(p)


def test_hdf5_without_h5py_names_it_and_the_alternatives(tmp_path, monkeypatch):
    """The card's machine has no h5py: opening a .h5 there says so."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"needs h5py.*\.npy clip.*video container"):
        open_source(tmp_path / "clip.h5")


def test_open_source_by_suffix(tmp_path, files, video, monkeypatch):
    np.save(tmp_path / "c.npy", video.frames[:4])
    assert isinstance(open_source(tmp_path / "c.npy"), ArraySource)
    for suffix in (".h5", ".hdf5"):
        p = _write_h5(tmp_path / f"c{suffix}", _png(video.frames[:3]))
        src = open_source(p, start=1)
        assert isinstance(src, HDF5Source) and src.total_frames == 2
        src.close()
    monkeypatch.setenv("SWTPU_DECODE_WORKERS", str(WORKERS))
    src = open_source(files["mp4"])
    theirs = jax_readers.open_source(files["mp4"])
    assert isinstance(src, VideoFileSource) and src.backend == theirs.backend
    src.close()
    theirs.close()


@pytest.mark.parametrize("kind, backend", BACKENDS)
def test_backend_frames_vs_jax(files, video, kind, backend):
    _skip_without(backend)
    ours = VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS)
    theirs = jax_readers.VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS)
    ref = jax_readers.VideoFileSource(files[kind], backend="cv2")
    try:
        assert ours.backend == theirs.backend == backend
        assert ours.supports_seek == theirs.supports_seek
        assert ours.supports_seek == (backend in ("parallel", "av"))
        assert (ours.fps, ours.start_frame, ours.end_frame, ours.total_frames) == (
            theirs.fps, theirs.start_frame, theirs.end_frame, theirs.total_frames)
        n = len(video.frames) + 3           # the inclusive end, then null frames
        a, na = _walk(ours, n)
        b, nb = _walk(theirs, n)
        c, nc = _walk(ref, n)
        assert na == nb == nc == list(range(64)) + [-1, -1]
        _same_frames(a, b)
        if backend != "native":
            # native decodes MJPG with libjpeg, cv2 with FFmpeg's decoder:
            # other pixels, so the native backend is held to the JAX one only
            _same_frames(a, c)
        assert ours.read_errors == theirs.read_errors == 1
    finally:
        for s in (ours, theirs, ref):
            s.close()


@pytest.mark.parametrize("kind", ["avi", "mp4"])
@pytest.mark.parametrize("workers", [1, WORKERS])
def test_auto_takes_the_jax_packages_backend(files, kind, workers, monkeypatch):
    monkeypatch.setenv("SWTPU_DECODE_WORKERS", str(workers))
    ours, theirs = VideoFileSource(files[kind]), jax_readers.VideoFileSource(files[kind])
    try:
        assert ours.backend == theirs.backend
        if ours.backend == "parallel":
            assert ours.decode_workers == workers
    finally:
        ours.close()
        theirs.close()


def test_backends_that_cannot_engage_raise(files, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="not an MJPG AVI"):
        VideoFileSource(files["mp4"], backend="native")
    bogus = tmp_path / "noise.mp4"
    bogus.write_bytes(b"\x00" * 4096)
    with pytest.raises((ValueError, RuntimeError)):
        VideoFileSource(bogus, backend="av")
    with pytest.raises(RuntimeError, match="could not open"):
        VideoFileSource(tmp_path / "missing.mp4", backend="cv2")
    with pytest.raises(ValueError, match="unknown decode backend"):
        VideoFileSource(files["mp4"], backend="ffmpeg")
    from swiftwatcher_tpu_torch.io import parallel_decode

    monkeypatch.setattr(parallel_decode, "probe_seek_accuracy", lambda *a: False)
    with pytest.raises(ValueError, match="not frame-accurate"):
        VideoFileSource(files["mp4"], backend="parallel", decode_workers=WORKERS)


CROPS = {"chimney": None, "corner": [(0, 0), (64, 48)], "edge": [(250, 190), (320, 240)]}


@pytest.mark.parametrize("backend", ["av", "parallel"])
@pytest.mark.parametrize("crop", sorted(CROPS))
def test_gray_crop_windows_vs_jax(files, video, backend, crop):
    _skip_without("av")                     # both gray streams decode through libav
    region = CROPS[crop] or crop_region_from_corners(video.corners, DEFAULT_CONFIG)
    ours = VideoFileSource(files["mp4"], backend=backend, decode_workers=WORKERS)
    theirs = jax_readers.VideoFileSource(files["mp4"], backend=backend,
                                         decode_workers=WORKERS)
    try:
        assert ours.enable_gray_crop_stream(region) and theirs.enable_gray_crop_stream(region)
        assert ours.enable_gray_crop_stream(region)          # the same crop again
        assert not ours.enable_gray_crop_stream([(0, 0), (8, 8)])
        for _ in range(4):                  # 84 frames: the end and null frames
            a, na, _ = ours.get_gray_crop_window(21)
            b, nb, _ = theirs.get_gray_crop_window(21)
            assert na == nb
            np.testing.assert_array_equal(a, b)
        assert na[-1] == -1 and ours.read_errors == theirs.read_errors == 1
        with pytest.raises(RuntimeError, match="get_gray_crop_window"):
            ours.read_frame(0)
    finally:
        ours.close()
        theirs.close()


def test_gray_crop_stream_needs_its_backend_and_bounds(files):
    src = VideoFileSource(files["mp4"], backend="cv2")
    assert not src.enable_gray_crop_stream([(0, 0), (8, 8)])
    src.close()
    if native_av.is_available():
        src = VideoFileSource(files["mp4"], backend="av")
        assert not src.enable_gray_crop_stream([(-4, 0), (8, 8)])
        assert not src.enable_gray_crop_stream([(0, 0), (8, 241)])
        src.close()


def _batches(pf, n):
    out = []
    for _ in range(n):
        b = pf.next()
        if b is None:
            break
        out.append((np.asarray(b[0]), [w[1] for w in b[1]], b[2]))
    pf.close()
    return out


PREFETCH_CASES = [
    ("mp4", "av", "gray_stream"), ("mp4", "parallel", "gray_stream"),
    ("mp4", "cv2", "frames"), ("avi", "native", "frames"), ("h5", None, "encoded"),
]


@pytest.mark.parametrize("kind, backend, mode", PREFETCH_CASES)
def test_prefetcher_paths_vs_jax(tmp_path, files, video, kind, backend, mode):
    _skip_without("av" if mode == "gray_stream" else "native" if kind != "mp4" else "cv2")
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=2, prefetch_depth=2,
                              native_decode=True)
    jcfg = dataclasses.replace(JAX_CONFIG, batch_windows=2, prefetch_depth=2,
                               native_decode=True, wire_codec="none")
    region = crop_region_from_corners(video.corners, cfg)
    if kind == "h5":
        p = _write_h5(tmp_path / "clip.h5", _jpg(video.frames))
        ours, theirs = HDF5Source(p), jax_readers.HDF5Source(p)
    else:
        ours = VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS)
        theirs = jax_readers.VideoFileSource(files[kind], backend=backend,
                                             decode_workers=WORKERS)
    try:
        pf = WindowPrefetcher(ours, region, CPU, cfg, frame_hw=video.frames.shape[1:3])
        assert pf.mode == mode
        a = _batches(pf, 3)
        b = _batches(JaxPrefetcher(theirs, region, jcfg, frame_hw=video.frames.shape[1:3]), 3)
        assert len(a) == len(b) == 2        # 63 frames: 2 batches of 2 windows
        for (ga, na, ca), (gb, nb, cb) in zip(a, b):
            np.testing.assert_array_equal(ga, gb)
            assert na == nb and ca == cb
        assert ours.read_errors == theirs.read_errors
    finally:
        ours.close()
        if kind != "h5":                    # the JAX package's HDF5Source has no close
            theirs.close()


@pytest.mark.parametrize("codec", ["delta4", "delta6"])
@pytest.mark.parametrize("kind, backend, mode", PREFETCH_CASES)
def test_prefetcher_paths_with_codec_vs_jax(tmp_path, files, video, kind, backend, mode, codec):
    """The wire codec encodes the gray batch whichever path formed it: each
    packet decodes to the JAX package's raw batch, and the bytes shipped
    are its prefetcher's under the same codec."""
    from swiftwatcher_tpu_torch.io.wirecodec import WirePacket, WirePacket6, decode_packet

    _skip_without("av" if mode == "gray_stream" else "native" if kind != "mp4" else "cv2")
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=2, prefetch_depth=2,
                              native_decode=True, wire_codec=codec)
    region = crop_region_from_corners(video.corners, cfg)
    hw = video.frames.shape[1:3]

    h5 = _write_h5(tmp_path / "clip.h5", _jpg(video.frames)) if kind == "h5" else None

    def sources():
        if kind == "h5":
            return HDF5Source(h5), jax_readers.HDF5Source(h5)
        return (VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS),
                jax_readers.VideoFileSource(files[kind], backend=backend,
                                            decode_workers=WORKERS))

    ours, theirs = sources()
    raw_ours, raw_theirs = sources()
    try:
        pf = WindowPrefetcher(ours, region, CPU, cfg, frame_hw=hw)
        assert pf.mode == mode and pf.codec == codec
        got = []
        while (b := pf.next()) is not None:
            assert isinstance(b[0], WirePacket6 if codec == "delta6" else WirePacket)
            got.append(decode_packet(b[0]).numpy())
        pf.close()
        jcfg = dataclasses.replace(JAX_CONFIG, batch_windows=2, prefetch_depth=2,
                                   native_decode=True, wire_codec=codec)
        jpf = JaxPrefetcher(theirs, region, jcfg, frame_hw=hw)
        while jpf.next() is not None:
            pass
        jpf.close()
        want = _batches(JaxPrefetcher(raw_theirs, region, dataclasses.replace(
            jcfg, wire_codec="none"), frame_hw=hw), 3)
        assert len(got) == len(want) == 2
        for g, (w, _, _) in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(g.shape))
        assert pf.bytes_uploaded == jpf.wire_bytes and pf.batches_by_format[codec] == 2
    finally:
        for src in (ours, raw_ours) + (() if kind == "h5" else (theirs, raw_theirs)):
            src.close()


def _csvs(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


@pytest.mark.parametrize("kind, backend", BACKENDS)
def test_run_video_csvs_vs_jax(tmp_path, files, video, kind, backend):
    """The port's device tracker (the CLI's default) against the JAX
    package's host tracker, each on the same backend."""
    _skip_without(backend)
    src = VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS)
    res = run_video(src, video.corners, DEFAULT_CONFIG, CPU, export_dir=tmp_path / "torch",
                    tracker_impl="device")
    src.close()
    src = jax_readers.VideoFileSource(files[kind], backend=backend, decode_workers=WORKERS)
    jres = jax_run_video(src, video.corners, JAX_CONFIG, export_dir=tmp_path / "jax",
                         tracker_impl="host")
    src.close()
    assert (res.total_predicted, res.total_rejected) == (
        jres.total_predicted, jres.total_rejected) == (2, 1)
    want = _csvs(tmp_path / "jax")
    assert len(want) == 6 and _csvs(tmp_path / "torch") == want


@pytest.mark.parametrize("backend, tracker", [("parallel", "device"), ("parallel", "host"),
                                              ("av", "device")])
def test_checkpoint_resume_on_a_seekable_mp4(tmp_path, files, video, backend, tracker):
    _skip_without(backend)
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1)

    def source():
        return VideoFileSource(files["mp4"], backend=backend, decode_workers=WORKERS)

    def events(r):
        return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]

    src = source()
    full = run_video(src, video.corners, cfg, CPU, tracker_impl=tracker)
    src.close()
    ck = tmp_path / "state.ckpt"
    src = source()
    src.end_frame = src.total_frames = 42
    run_video(src, video.corners, cfg, CPU, tracker_impl=tracker, checkpoint_path=ck,
              checkpoint_interval_batches=1)
    src.close()
    assert ck.is_file()
    src = source()
    resumed = run_video(src, video.corners, cfg, CPU, tracker_impl=tracker,
                        checkpoint_path=ck, checkpoint_interval_batches=1)
    src.close()
    assert events(resumed) == events(full) and events(full)
    assert (resumed.total_predicted, resumed.total_rejected) == (
        full.total_predicted, full.total_rejected)


def test_a_sequential_source_refuses_to_resume(tmp_path, files, video):
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1)
    src = ArraySource(video.frames[:30], fps=30.0)
    src.filepath = files["mp4"]
    ck = tmp_path / "state.ckpt"
    run_video(src, video.corners, cfg, CPU, checkpoint_path=ck, checkpoint_interval_batches=1)
    src = VideoFileSource(files["mp4"], backend="cv2")
    with pytest.raises(ValueError, match="sequential source"):
        run_video(src, video.corners, cfg, CPU, checkpoint_path=ck)
    src.close()


def test_hdf5_native_decode_run_vs_jax(tmp_path, video):
    if not native.is_available():
        pytest.skip("no native frame pump on this host")
    p = _write_h5(tmp_path / "clip.h5", _jpg(video.frames), fps=video.fps)
    cfg = dataclasses.replace(DEFAULT_CONFIG, native_decode=True)
    jcfg = dataclasses.replace(JAX_CONFIG, native_decode=True)
    ours = run_video(HDF5Source(p), video.corners, cfg, CPU, export_dir=tmp_path / "torch")
    theirs = jax_run_video(jax_readers.HDF5Source(p), video.corners, jcfg,
                           export_dir=tmp_path / "jax", tracker_impl="host")
    assert [e.frame_number for e in ours.events] == [e.frame_number for e in theirs.events]
    assert _csvs(tmp_path / "torch") == _csvs(tmp_path / "jax")
    assert (ours.total_predicted, ours.total_rejected) == (2, 1)
