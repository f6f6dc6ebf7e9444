"""The port's wire codec (swiftwatcher_tpu_torch/io/wirecodec.py) against
the JAX package's on the CPU: the encoders' packets byte for byte (numpy
and the C twin of csrc/wire_encode.cpp), the torch decodes bit-lossless on
fuzz, adversarial and realistic batches (padding indices past the end,
the level-2 gather's clip, mod-256 sums), packed localisation equal to the
raw batch's, and run_video with each forced codec equal to the raw run and
to the JAX package's run with the same codec (events, CSVs, wire bytes),
through an escape overflow, `auto` on the CPU, a checkpoint resume and a
gloo mesh."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io import wirecodec as jax_codec
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io import native, wirecodec
from swiftwatcher_tpu_torch.io.prefetch import WindowPrefetcher, link_rate
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.pipeline.runner import run_video
from swiftwatcher_tpu_torch.pipeline.window import (
    localize_windows_gray,
    localize_windows_packed,
    localize_windows_packed6,
)

CPU = torch.device("cpu")
FIELDS4 = ("first", "packed", "esc_idx", "esc_val")
FIELDS6 = ("bg", "lvl1", "lvl2", "esc_idx", "esc_val")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["numpy", "native"])
def encoder(request, monkeypatch):
    """Which encoder the port's encode_* take: its numpy one, or the C
    twin where g++ built it."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "has_symbol", lambda name: False)
    elif not native.has_symbol("swt_encode_delta6"):
        pytest.skip("g++ built no wire encoders here")
    return request.param


def _jax_numpy_encoders(monkeypatch):
    """The JAX package's numpy encoders (its native twin off)."""
    from swiftwatcher_tpu.io import native as jax_native

    monkeypatch.setattr(jax_native, "is_available", lambda: False)


def _content(rng, kind, shape):
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "static":
        b = rng.integers(0, 256, (1, *shape[1:]), np.int16)
        return (b + rng.integers(-4, 5, shape)).clip(0, 255).astype(np.uint8)
    return np.broadcast_to(rng.integers(0, 256, (1, *shape[1:]), np.uint8), shape).copy()


def _roundtrip(gray, fmt, cap=None, mode=None):
    cap = gray.size + 1 if cap is None else cap
    if fmt == "delta4":
        pkt = wirecodec.encode_delta4(gray, cap)
        up = wirecodec.device_put_packet(pkt, CPU)
    else:
        pkt = wirecodec.encode_delta6(gray, cap, mode=mode)
        up = wirecodec.device_put_packet6(pkt, CPU)
    out = wirecodec.decode_packet(up)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), gray)
    return pkt


@pytest.mark.parametrize("kind", ["noise", "static", "frozen"])
def test_packets_byte_equal_to_jax(kind, encoder, monkeypatch):
    _jax_numpy_encoders(monkeypatch)
    rng = np.random.default_rng(11)
    for _ in range(4):
        N, H, W = (int(v) for v in rng.integers(1, 14, 3))
        gray = _content(rng, kind, (N, H, W))
        for mode in (None, 0, 1):
            ours = wirecodec.encode_delta6(gray, gray.size + 1, mode=mode)
            theirs = jax_codec.encode_delta6(gray, gray.size + 1, mode=mode)
            assert isinstance(ours.mode, int) and ours.mode == int(theirs.mode)
            for f in FIELDS6:
                np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
            assert ours.nbytes == theirs.nbytes and ours.shape == theirs.shape
        if N >= 2:
            ours = wirecodec.encode_delta4(gray, gray.size)
            theirs = jax_codec.encode_delta4(gray, gray.size)
            for f in FIELDS4:
                np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
            assert ours.nbytes == theirs.nbytes


def test_native_twin_byte_equal_to_numpy(monkeypatch):
    if not native.has_symbol("swt_encode_delta4"):
        pytest.skip("g++ built no wire encoders here")
    rng = np.random.default_rng(12)
    cases = [_content(rng, ("noise", "static", "frozen")[i % 3],
                      tuple(int(v) for v in rng.integers(1, 31, 3))) for i in range(9)]
    got = [(wirecodec.encode_delta4(g, g.size), [wirecodec.encode_delta6(g, g.size + 1, m)
                                                 for m in (None, 0, 1)]) for g in cases]
    monkeypatch.setattr(native, "has_symbol", lambda name: False)
    for g, (p4, p6s) in zip(cases, got):
        want4 = wirecodec.encode_delta4(g, g.size)
        if want4 is None:
            assert p4 is None and g.shape[0] < 2
        else:
            for f in FIELDS4:
                np.testing.assert_array_equal(getattr(p4, f), getattr(want4, f))
        for m, p6 in zip((None, 0, 1), p6s):
            want6 = wirecodec.encode_delta6(g, g.size + 1, m)
            assert p6.mode == want6.mode
            for f in FIELDS6:
                np.testing.assert_array_equal(getattr(p6, f), getattr(want6, f))


@pytest.mark.parametrize("fmt", ["delta4", "delta6"])
def test_decode_lossless_fuzz(fmt, encoder):
    rng = np.random.default_rng(13)
    for i in range(9):
        shape = (int(rng.integers(2, 12)), int(rng.integers(1, 24)), int(rng.integers(1, 24)))
        gray = _content(rng, ("noise", "static", "frozen")[i % 3], shape)
        for mode in ((None,) if fmt == "delta4" else (None, 0, 1)):
            _roundtrip(gray, fmt, mode=mode)


@pytest.mark.parametrize("fmt", ["delta4", "delta6"])
def test_decode_lossless_adversarial(fmt, encoder):
    rng = np.random.default_rng(14)
    alt = np.zeros((6, 5, 7), np.uint8)
    alt[1::2] = 255                       # residual -1 / +1 mod 256 every frame
    ramp = (np.arange(8, dtype=np.uint8)[:, None, None] * 37
            + np.arange(9, dtype=np.uint8).reshape(3, 3)[None])
    # 336 frames of +255 steps: prefix sums far past 255 (mod-256 in int32)
    climb = (np.arange(336, dtype=np.int64)[:, None, None] * 255 % 256).astype(np.uint8)
    cases = [np.zeros((4, 3, 3), np.uint8), np.full((4, 3, 3), 255, np.uint8), alt, ramp,
             np.broadcast_to(climb, (336, 2, 5)).copy()]
    cases += [rng.integers(0, 256, (3, 1, w), np.uint8) for w in (5, 6, 7)]  # base-6 edges
    for gray in cases:
        for mode in ((None,) if fmt == "delta4" else (None, 0, 1)):
            _roundtrip(gray, fmt, mode=mode)
    if fmt == "delta6":
        _roundtrip(rng.integers(0, 256, (1, 9, 11), np.uint8), fmt)   # one frame


def test_decode_lossless_realistic_and_compresses(encoder):
    """Sensor noise of +-2 gray levels on a static scene: both formats
    lossless, delta6 under 0.8 of delta4 and 0.45 of raw (the JAX
    package's own claim, tests/test_wirecodec.py); and lossless with a dark
    blob crossing it."""
    rng = np.random.default_rng(15)
    base = rng.integers(60, 200, (64, 96), np.uint8)
    frames = (base[None].astype(np.int16) + rng.integers(-2, 3, (40, 64, 96)))
    p4 = _roundtrip(frames.clip(0, 255).astype(np.uint8), "delta4", cap=256)
    p6 = _roundtrip(frames.clip(0, 255).astype(np.uint8), "delta6", cap=256)
    assert p6.nbytes < 0.8 * p4.nbytes and p6.nbytes < 0.45 * frames.size
    for t in range(40):
        frames[t, 20:26, 2 * t : 2 * t + 6] -= 100
    frames = frames.clip(0, 255).astype(np.uint8)
    _roundtrip(frames, "delta4", cap=8192)
    for mode in (None, 0, 1):
        _roundtrip(frames, "delta6", cap=8192, mode=mode)


def test_padding_past_the_end_is_dropped():
    """Padding indices (one past the end, or any other out-of-range value)
    must not reach torch's scatter, which raises on them (and asserts on a
    card): they land in a spare element that is dropped."""
    r = torch.arange(10, dtype=torch.int32)
    idx = torch.tensor([3, 10, 10, 42, -1, 7], dtype=torch.int32)
    val = torch.tensor([200, 1, 2, 3, 4, 100], dtype=torch.uint8)
    out = wirecodec._scatter_drop(r, idx, val)
    want = np.arange(10)
    want[3], want[7] = 200, 100
    np.testing.assert_array_equal(out.numpy(), want)


def test_level2_gather_clipped_and_bucket_padding(encoder):
    """No level-1 escape (ordinal -1 everywhere, lvl2 of one byte) and a
    level-2 stream padded past its size, as the prefetcher's buckets pad
    it: the gather's index is clipped to the stream and the decode holds."""
    rng = np.random.default_rng(16)
    quiet = np.broadcast_to(rng.integers(0, 256, (1, 7, 9), np.uint8), (5, 7, 9)).copy()
    pkt = wirecodec.encode_delta6(quiet, 8)
    assert pkt.lvl2.size == 1
    noisy = _content(rng, "static", (5, 7, 9))
    for gray in (quiet, noisy):
        pkt = wirecodec.encode_delta6(gray, gray.size)
        pkt.lvl2 = np.pad(pkt.lvl2, (0, 512 - pkt.lvl2.size % 512))
        n3 = int(np.count_nonzero(pkt.esc_idx < gray.size))
        pkt.esc_idx, pkt.esc_val = pkt.esc_idx[: n3 + 3], pkt.esc_val[: n3 + 3]
        out = wirecodec.decode_packet(wirecodec.device_put_packet6(pkt, CPU))
        np.testing.assert_array_equal(out.numpy(), gray)


def test_overflow_returns_none_and_mode_selection(encoder, monkeypatch):
    _jax_numpy_encoders(monkeypatch)
    rng = np.random.default_rng(17)
    noisy = rng.integers(0, 256, (8, 16, 16), np.uint8)
    assert wirecodec.encode_delta4(noisy, 4) is None
    assert wirecodec.encode_delta6(noisy, 4) is None
    assert wirecodec.encode_delta4(noisy[:1], 64) is None
    base = rng.integers(60, 200, (32, 48), np.uint8)
    static = (base[None].astype(np.int16) + rng.integers(-3, 4, (20, 32, 48))).clip(
        0, 255).astype(np.uint8)
    drift = ((np.arange(20)[:, None, None] * 3 + base[None].astype(np.int32)) % 256).astype(
        np.uint8)
    for gray, want in ((static, 0), (drift, 1)):
        assert wirecodec.encode_delta6(gray, gray.size).mode == want
        assert int(jax_codec.encode_delta6(gray, gray.size).mode) == want


@pytest.mark.parametrize("fmt", ["delta4", "delta6"])
def test_packed_localization_equals_raw(fmt):
    rng = np.random.default_rng(18)
    B, T, H, W = 2, DEFAULT_CONFIG.window_size, 24, 40
    base = rng.integers(90, 170, (H, W), np.uint8)
    gray = np.broadcast_to(base, (B, T, H, W)).astype(np.int16)
    gray = gray + rng.integers(-2, 3, gray.shape)
    for t in range(T):
        gray[0, t, 4:8, t + 2 : t + 6] -= 90      # a dark blob crossing window 0
    gray = gray.clip(0, 255).astype(np.uint8)
    flat = gray.reshape(B * T, H, W)
    if fmt == "delta4":
        pkt = wirecodec.device_put_packet(wirecodec.encode_delta4(flat, 4096), CPU)
        t_pkt, it_pkt = localize_windows_packed(pkt, (B, T, H, W), DEFAULT_CONFIG)
    else:
        pkt = wirecodec.device_put_packet6(wirecodec.encode_delta6(flat, 4096), CPU)
        t_pkt, it_pkt = localize_windows_packed6(pkt, (B, T, H, W), DEFAULT_CONFIG)
    t_raw, it_raw = localize_windows_gray(torch.from_numpy(gray), DEFAULT_CONFIG)
    assert t_raw.valid.any()
    for f in dataclasses.fields(t_raw):
        np.testing.assert_array_equal(getattr(t_pkt, f.name).numpy(),
                                      getattr(t_raw, f.name).numpy())
    np.testing.assert_array_equal(it_pkt.numpy(), it_raw.numpy())
    with pytest.raises(ValueError, match="batch"):
        localize_windows_packed6(pkt, (B, T, H, W + 1), DEFAULT_CONFIG)


@pytest.fixture(scope="module")
def video():
    return make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1)


def _events(r):
    return [(e.frame_number, e.timestamp, e.first_centroid, e.last_centroid) for e in r.events]


def _csvs(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


@pytest.fixture(scope="module")
def raw_run(video, tmp_path_factory):
    out = tmp_path_factory.mktemp("raw")
    r = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                  dataclasses.replace(DEFAULT_CONFIG, wire_codec="off"), CPU, export_dir=out)
    return r, _csvs(out)


@pytest.mark.parametrize("codec", ["delta4", "delta6"])
def test_run_video_codec_equals_raw_and_jax(video, raw_run, codec, tmp_path):
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                     dataclasses.replace(DEFAULT_CONFIG, wire_codec=codec), CPU,
                     export_dir=ours_dir)
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, wire_codec=codec),
                           export_dir=theirs_dir)
    raw, raw_csvs = raw_run
    assert _events(ours) == _events(raw) and len(raw.events) == 2
    assert [e.frame_number for e in ours.events] == [e.frame_number for e in theirs.events]
    assert len(raw_csvs) == 6 and _csvs(ours_dir) == raw_csvs == _csvs(theirs_dir)
    assert ours.metrics.wire_bytes == theirs.metrics.wire_bytes < raw.metrics.wire_bytes


@pytest.mark.parametrize("codec", ["delta4", "delta6"])
def test_overflowing_batch_ships_raw(video, raw_run, codec):
    """A scene cut of i.i.d. noise in the second of three one-window
    batches overflows its escape cap: that batch ships raw, the others
    encoded; events equal the raw run's, wire bytes the JAX package's."""
    frames = video.frames.copy()
    frames[28:34] = np.random.default_rng(19).integers(0, 256, frames[28:34].shape, np.uint8)
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1, wire_codec=codec,
                              wire_escape_cap=8192)
    pf = WindowPrefetcher(ArraySource(frames, fps=video.fps),
                          ((0, 0), (frames.shape[2], frames.shape[1])), CPU, cfg)
    kinds = []
    while (batch := pf.next()) is not None:
        kinds.append(type(batch[0]).__name__)
    pf.close()
    assert kinds == [f"WirePacket{'6' if codec == 'delta6' else ''}", "Tensor",
                     f"WirePacket{'6' if codec == 'delta6' else ''}"]
    assert pf.batches_by_format == {"raw": 1, codec: 2, ("delta4" if codec == "delta6" else
                                                         "delta6"): 0}
    run = dict(wire_codec="off", batch_windows=1)
    raw = run_video(ArraySource(frames, fps=video.fps), video.corners,
                    dataclasses.replace(DEFAULT_CONFIG, **run), CPU)
    ours = run_video(ArraySource(frames, fps=video.fps), video.corners, cfg, CPU)
    theirs = jax_run_video(JaxArraySource(frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, batch_windows=1, wire_codec=codec,
                                               wire_escape_cap=8192))
    assert _events(ours) == _events(raw)
    assert [e.frame_number for e in ours.events] == [e.frame_number for e in theirs.events]
    assert raw.metrics.wire_bytes > ours.metrics.wire_bytes == theirs.metrics.wire_bytes


def test_auto_ships_raw_on_the_cpu(video, raw_run):
    assert link_rate(CPU) > DEFAULT_CONFIG.wire_auto_mbps * 1e6
    assert DEFAULT_CONFIG.wire_codec == "auto"
    pf = WindowPrefetcher(ArraySource(video.frames, fps=video.fps),
                          ((0, 0), (video.frames.shape[2], video.frames.shape[1])), CPU,
                          DEFAULT_CONFIG)
    pf.close()
    assert pf.codec is None and pf.link_bytes_per_s > 1e9
    auto = run_video(ArraySource(video.frames, fps=video.fps), video.corners, DEFAULT_CONFIG,
                     CPU)
    assert _events(auto) == _events(raw_run[0])
    # one batch of 16 windows (3 real, 13 repeats) of 36 x 72 crops
    assert auto.metrics.wire_bytes == raw_run[0].metrics.wire_bytes == 16 * 21 * 36 * 72


@pytest.mark.parametrize("impl", ["host", "device"])
def test_checkpoint_resume_with_codec(video, tmp_path, impl):
    class Cut(Exception):
        pass

    def cut_after_two(done, total):
        cut_after_two.n += 1
        if cut_after_two.n == 2:
            raise Cut

    cut_after_two.n = 0
    cfg = dataclasses.replace(DEFAULT_CONFIG, wire_codec="delta6", batch_windows=1)
    full = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                     tracker_impl=impl)
    path = tmp_path / "ckpt.json"
    with pytest.raises(Cut):
        run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                  tracker_impl=impl, checkpoint_path=path, checkpoint_interval_batches=1,
                  status_cb=cut_after_two)
    assert json.loads(path.read_text())["frames_processed"] == 42
    resumed = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                        tracker_impl=impl, checkpoint_path=path, checkpoint_interval_batches=1)
    assert _events(resumed) == _events(full) and full.events
    assert resumed.frames_processed == 63 and len(resumed.ialm_iters) == 1


def test_mesh_run_with_delta6(video, raw_run):
    """--mesh decodes on rank 0's device, then shards: a (2, 1) gloo mesh
    with delta6 gives the raw unsharded run's events and the unsharded
    delta6 run's wire bytes."""
    from swiftwatcher_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=2, wire_codec="delta6")
    plain = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU)
    with make_mesh((2, 1), device="cpu", timeout=120) as mesh:
        sharded = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                            mesh=mesh, tracker_impl="device")
    assert [e.frame_number for e in sharded.events] == [e.frame_number
                                                        for e in raw_run[0].events]
    assert (sharded.total_predicted, sharded.total_rejected) == (
        raw_run[0].total_predicted, raw_run[0].total_rejected)
    assert sharded.metrics.wire_bytes == plain.metrics.wire_bytes < raw_run[0].metrics.wire_bytes
