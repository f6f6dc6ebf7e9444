"""Port vs JAX package end to end: run_video on the scenes of
tests/test_end_to_end.py, with the warm-basis and the cold-start solver.
Events (frame numbers and centroids), predicted and rejected counts, and
ground truth are equal; exported CSVs are byte-equal.  Each package runs
with its own DEFAULT_CONFIG.  The device tracker (on the CPU, its plain
version) gives the events of the port's host tracker and of the JAX
package's device tracker (tests/test_device_runner.py's scenes)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.io.export import frame_timestamp
from swiftwatcher_tpu.io.synthetic import make_video
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.pipeline import runner as runner_mod
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on one host, and torch's default of a thread
    per core makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SCENES = {
    "seed0": dict(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1),
    "seed1": dict(seed=1, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1),
    "no_motion": dict(seed=3, n_frames=42, n_entering=0, n_crossing=0),
    "null_tail": dict(seed=1923779129, n_frames=45, H=240, W=320, n_entering=0,
                      n_crossing=0, n_vanishing=2, noise=3, dot=5,
                      brightness_drift=0.15),
}


def _events(result):
    return [(e.frame_number, e.first_centroid, e.last_centroid) for e in result.events]


def _both(video, warm=True, **kw):
    ours = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                     dataclasses.replace(DEFAULT_CONFIG, rpca_warm_basis=warm), CPU, **kw)
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, rpca_warm_basis=warm),
                           tracker_impl="host", **kw)
    return ours, theirs


# warm cases keep the bare scene name as their id
CASES = [pytest.param(s, True, id=s) for s in sorted(SCENES)] + [
    pytest.param(s, False, id=f"{s}-cold") for s in sorted(SCENES)
]


@pytest.mark.parametrize("scene, warm", CASES)
def test_run_video_vs_jax(scene, warm):
    video = make_video(**SCENES[scene])
    ours, theirs = _both(video, warm)
    assert _events(ours) == _events(theirs)
    assert ours.total_predicted == theirs.total_predicted
    assert ours.total_rejected == theirs.total_rejected
    assert ours.frames_processed == theirs.frames_processed
    assert all(fn >= 0 for fn, _, _ in _events(ours))
    if scene.startswith("seed"):
        assert ours.total_predicted == video.n_entering
        assert ours.total_rejected == video.n_vanishing
    if scene == "no_motion":
        assert ours.events == [] and ours.classified is None


def test_exported_csvs_byte_equal(tmp_path):
    video = make_video(**SCENES["seed0"])
    ours = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                     DEFAULT_CONFIG, CPU, export_dir=tmp_path / "torch")
    jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                  JAX_CONFIG, export_dir=tmp_path / "jax", tracker_impl="host")
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert len(names) == 6
    assert sorted(p.name for p in (tmp_path / "torch").glob("*.csv")) == names
    for n in names:
        assert (tmp_path / "torch" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
    assert (ours.export_dir / "run_manifest.json").is_file()


@pytest.mark.parametrize("kw", [{"mesh": types.SimpleNamespace(shape={"data": 3, "model": 1},
                                                              device=CPU)}])
def test_unported_options_raise(kw):
    """`mesh`, the last option ported (ROADMAP.md section 1 item 6), raises
    as the JAX package's run_video does where the batch does not divide
    over the mesh's 'data' axis (the 16 windows over 3 ranks here).
    tests/test_torch_mesh_runner.py runs it on a mesh."""
    video = make_video(seed=0, n_frames=21, n_entering=0, n_crossing=0)
    with pytest.raises(ValueError, match="must divide over the mesh 'data' axis"):
        run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                  DEFAULT_CONFIG, CPU, **kw)


@pytest.mark.parametrize("impl", ["host", "device"])
def test_profile_dir_writes_a_trace_and_device_times(tmp_path, impl):
    """profile_dir: the trace names the JAX package's stage annotations, the
    manifest (no export dir: into profile_dir) carries the device times,
    and the events are the unprofiled run's."""
    import json

    video = make_video(**SCENES["seed0"])
    plain = _run(video, impl)
    prof = _run(video, impl, profile_dir=tmp_path / "prof")
    assert _events(prof) == _events(plain)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    want = {"localize_dispatch", "consume"} | ({"track_dispatch"} if impl == "device" else set())
    assert want <= names
    manifest = json.loads((tmp_path / "prof" / "run_manifest.json").read_text())
    stages = {"localize"} | ({"track_scan"} if impl == "device" else set())
    assert set(manifest["device_stage_seconds"]) == stages
    assert set(prof.metrics.device_stage_seconds) == stages
    assert not plain.metrics.device_stage_seconds


@pytest.mark.parametrize("impl", ["host", "device"])
def test_stabilised_run_vs_jax(impl):
    """stabilize_max_shift=3 (the --accuracy-pack shift) on a jittered
    scene: the JAX package's events and counts, on either tracker."""
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video

    video = make_hard_video(seed=49, n_entering=3, jitter=2, n_frames=63)
    cfg = dataclasses.replace(DEFAULT_CONFIG, stabilize_max_shift=3)
    ours = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                     tracker_impl=impl)
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, stabilize_max_shift=3),
                           tracker_impl="host")
    assert [e.frame_number for e in ours.events] == [e.frame_number for e in theirs.events]
    # the device tracker keeps f32 centroids, the host tracker f64
    np.testing.assert_allclose([e.first_centroid + e.last_centroid for e in ours.events],
                               [e.first_centroid + e.last_centroid for e in theirs.events],
                               rtol=0, atol=1e-3 if impl == "device" else 0)
    assert (ours.total_predicted, ours.total_rejected) == (
        theirs.total_predicted, theirs.total_rejected)
    assert ours.events


def _run(video, impl, cfg=DEFAULT_CONFIG, **kw):
    return run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                     tracker_impl=impl, **kw)


DEVICE_CASES = [pytest.param(seed, n, warm, id=f"seed{seed}{'' if warm else '-cold'}")
                for seed, n in ((0, 63), (1, 50)) for warm in (True, False)]


@pytest.mark.parametrize("seed, n_frames, warm", DEVICE_CASES)
def test_device_tracker_vs_host_and_jax(seed, n_frames, warm):
    """The port's device tracker against its host tracker (frame numbers
    and stamps equal, centroids within 1e-3: f32 against f64) and against
    the JAX package's device tracker (events equal)."""
    video = make_video(seed=seed, n_frames=n_frames, n_entering=2, n_crossing=1, n_vanishing=1)
    cfg = dataclasses.replace(DEFAULT_CONFIG, rpca_warm_basis=warm)
    dev, host = _run(video, "device", cfg), _run(video, "host", cfg)
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, rpca_warm_basis=warm),
                           tracker_impl="device")
    for other in (host, theirs):
        assert (dev.total_predicted, dev.total_rejected, dev.frames_processed) == (
            other.total_predicted, other.total_rejected, other.frames_processed)
    assert dev.total_predicted == video.n_entering and dev.total_rejected == video.n_vanishing
    key = lambda e: (e.frame_number, e.first_centroid, e.last_centroid)  # noqa: E731
    ours, mine = sorted(dev.events, key=key), sorted(host.events, key=key)
    assert [e.frame_number for e in ours] == [e.frame_number for e in mine]
    assert [e.timestamp for e in ours] == [e.timestamp for e in mine]
    for d, h in zip(ours, mine):
        np.testing.assert_allclose(d.first_centroid + d.last_centroid,
                                   h.first_centroid + h.last_centroid, atol=1e-3)
    assert _events(dev) == [(e.frame_number, e.first_centroid, e.last_centroid)
                            for e in theirs.events]
    assert [str(frame_timestamp(e.timestamp, video.fps)) for e in dev.events] == [
        str(e.timestamp) for e in theirs.events]
    assert dev.metrics.segments_total == 0 and dev.ialm_iters == host.ialm_iters


def test_track_overflows_count_real_frames_only(monkeypatch):
    """With one track slot, every frame with two or more segments
    overflows: here frames 43-46, where two dark blobs cross the crop.
    Frames of batch-padding windows (the last batch repeats its last window
    13 times) and null frames (solver noise, PARITY deviation 11) are not
    counted.  The JAX package counts its null frames too, so only its
    events are compared."""
    recorded = []
    real = runner_mod.compact_tables

    def recording(table, K, **kw):
        recorded.append(table.valid.sum(-1))
        return real(table, K, **kw)

    monkeypatch.setattr(runner_mod, "compact_tables", recording)
    video = make_video(seed=0, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1)
    for k, t in enumerate(range(43, 47)):          # inside the 72 x 36 crop
        for x in (135 + 6 * k, 180 - 6 * k):
            video.frames[t, 112:116, x:x + 4] //= 4
    ours = _run(video, "device", dataclasses.replace(DEFAULT_CONFIG, max_tracks=1))
    (n_valid,) = recorded
    fns = np.full((16, 21), -1)
    fns[:3].flat[:51] = np.arange(51)              # 3 windows: frames 0-50, then null
    want = int(((n_valid.numpy() > 1) & (fns >= 0))[:3].sum())
    assert ours.metrics.windows == 3 and ours.metrics.track_overflows == want >= 4
    assert int(((n_valid.numpy() > 1) & (fns[2] >= 0)).sum()) > want   # padding excluded
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, max_tracks=1), tracker_impl="device")
    assert _events(ours) == [(e.frame_number, e.first_centroid, e.last_centroid)
                             for e in theirs.events]


def test_event_buffer_overflow_raises(monkeypatch):
    real = runner_mod.track_window

    def overflowing(*args, **kw):
        state, events = real(*args, **kw)
        events.overflow.fill_(True)
        return state, events

    monkeypatch.setattr(runner_mod, "track_window", overflowing)
    video = make_video(seed=0, n_frames=21, n_entering=0, n_crossing=0)
    with pytest.raises(RuntimeError, match="event buffer overflow"):
        _run(video, "device")


@pytest.mark.parametrize("impl, uniform, match", [
    ("gpu", True, "tracker_impl"), ("device", False, "non-uniform timestamps")])
def test_bad_tracker_requests_raise(impl, uniform, match):
    """An unknown tracker, and the device tracker (which stamps events by
    frame number) on a source that declares non-uniform timestamps."""
    video = make_video(seed=0, n_frames=21, n_entering=0, n_crossing=0)
    src = ArraySource(video.frames, fps=video.fps)
    src.uniform_timestamps = uniform
    with pytest.raises(ValueError, match=match):
        run_video(src, video.corners, DEFAULT_CONFIG, CPU, tracker_impl=impl)


def test_partial_batch_pads_by_repeating_the_last_window():
    from swiftwatcher_tpu_torch.io.prefetch import WindowPrefetcher

    video = make_video(seed=0, n_frames=30, n_entering=0, n_crossing=0)
    src = ArraySource(video.frames, fps=video.fps)
    pre = WindowPrefetcher(src, crop_region_from_corners(video.corners), CPU, DEFAULT_CONFIG)
    try:
        gray, wins, cursor = pre.next()
        assert pre.next() is None
    finally:
        pre.close()
    assert gray.shape[0] == DEFAULT_CONFIG.batch_windows and len(wins) == 2
    assert torch.equal(gray[1], gray[-1])
    # inclusive end: frame 30 is read (a duplicated tail), then null frames
    assert wins[1][1][:11] == list(range(21, 31)) + [-1]
    assert cursor == (src.next_frame_number, 31)
    assert src.read_errors == 1
