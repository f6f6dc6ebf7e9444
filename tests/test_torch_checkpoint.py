"""Checkpoint and resume (swiftwatcher_tpu_torch/utils/checkpoint.py) with
both trackers on the CPU: a run cut after k of its n batches and resumed
from its checkpoint gives the events of an uncut run; a checkpoint the JAX
package wrote loads in the port and resumes to the same events; a
checkpoint of another video, of the other tracker, or on a source that
cannot seek is refused.  The stored time of day is the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.export import frame_timestamp
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu.utils import checkpoint as jax_checkpoint
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource, open_source
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.pipeline.runner import run_video
from swiftwatcher_tpu_torch.utils import checkpoint

CPU = torch.device("cpu")
# one window a batch: 105 frames are 5 batches
CFG = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1)
JAX_CFG = dataclasses.replace(JAX_CONFIG, batch_windows=1)
N_BATCHES = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on one host, and torch's default of a thread
    per core makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Cut(Exception):
    pass


@pytest.fixture(scope="module")
def video():
    return make_video(seed=0, n_frames=105, n_entering=4, n_crossing=1, n_vanishing=2)


def _source(video):
    return ArraySource(video.frames, fps=video.fps)


def _empty_state():
    from swiftwatcher_tpu_torch.pipeline.tracking_device import empty_state

    return empty_state(DEFAULT_CONFIG.max_tracks)


def _cut_after(k):
    def status(done, total):
        status.batches += 1
        if status.batches == k:
            raise Cut

    status.batches = 0
    return status


def _events(result):
    return [(e.frame_number, e.timestamp, e.first_centroid, e.last_centroid)
            for e in result.events]


@pytest.fixture(scope="module")
def uncut(video):
    return {impl: run_video(_source(video), video.corners, CFG, CPU, tracker_impl=impl)
            for impl in ("host", "device")}


@pytest.mark.parametrize("impl", ["host", "device"])
@pytest.mark.parametrize("k", [1, 3, N_BATCHES - 1])
def test_cut_and_resumed_run_equals_the_uncut_run(tmp_path, video, uncut, impl, k):
    path = tmp_path / "ckpt.json"
    with pytest.raises(Cut):
        run_video(_source(video), video.corners, CFG, CPU, tracker_impl=impl,
                  checkpoint_path=path, checkpoint_interval_batches=1, status_cb=_cut_after(k))
    saved = json.loads(path.read_text())
    assert saved["frames_processed"] == 21 * k
    assert ("tracker_impl" in saved) == (impl == "device")
    resumed = run_video(_source(video), video.corners, CFG, CPU, tracker_impl=impl,
                        checkpoint_path=path, checkpoint_interval_batches=1)
    full = uncut[impl]
    assert _events(resumed) == _events(full) and len(full.events) == 6
    assert (resumed.total_predicted, resumed.total_rejected) == (4, 2)
    assert resumed.frames_processed == full.frames_processed == 105
    assert len(resumed.ialm_iters) == N_BATCHES - k


@pytest.mark.parametrize("impl", ["host", "device"])
def test_resumes_a_checkpoint_of_the_jax_package(tmp_path, video, uncut, impl):
    path = tmp_path / "jax_ckpt.json"
    status = _cut_after(2)
    with pytest.raises(Cut):
        jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners, JAX_CFG,
                      tracker_impl=impl, checkpoint_path=path,
                      checkpoint_interval_batches=1, status_cb=status)
    src = _source(video)
    src.filepath = JaxArraySource(video.frames).filepath     # its fingerprint's name
    resumed = run_video(src, video.corners, CFG, CPU, tracker_impl=impl, checkpoint_path=path)
    assert _events(resumed) == _events(uncut[impl])


def test_the_jax_package_reads_the_time_of_day(tmp_path, video, uncut):
    """The JAX loader turns the port's stored stamps into the timestamps
    its own run gives the same frames."""
    path = tmp_path / "ckpt.json"
    events = uncut["host"].events
    checkpoint.save_checkpoint_device(path, 42, 42, _empty_state(), events, video.fps)
    _, _, _, loaded = jax_checkpoint.load_checkpoint_device(path)
    assert [str(e.timestamp) for e in loaded] == [
        str(frame_timestamp(e.frame_number, video.fps)) for e in events]


@pytest.mark.parametrize("fps", [25.0, 29.97, 30.0, 59.94])
def test_time_of_day_is_frame_timestamps(fps):
    """_time_of_day equals frame_timestamp's time of day as pandas prints
    it, including whole seconds and ties at microsecond rounding."""
    import pandas as pd

    for fn in [*range(0, 400), 1799, 1800, 107892, 2_589_410, 2_592_000, 10**7 + 3]:
        ts = frame_timestamp(fn, fps)
        assert pd.Timedelta(checkpoint._time_of_day(fn, fps)) == ts - ts.normalize(), fn


@pytest.mark.parametrize("impl", ["host", "device"])
def test_another_video_is_refused(tmp_path, video, impl):
    path = tmp_path / "ckpt.json"
    with pytest.raises(Cut):
        run_video(_source(video), video.corners, CFG, CPU, tracker_impl=impl,
                  checkpoint_path=path, checkpoint_interval_batches=1, status_cb=_cut_after(1))
    other = ArraySource(video.frames, fps=25.0)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_video(other, video.corners, CFG, CPU, tracker_impl=impl, checkpoint_path=path)


@pytest.mark.parametrize("impl, other", [("host", "device"), ("device", "host")])
def test_the_other_trackers_checkpoint_is_refused(tmp_path, video, impl, other):
    path = tmp_path / "ckpt.json"
    with pytest.raises(Cut):
        run_video(_source(video), video.corners, CFG, CPU, tracker_impl=impl,
                  checkpoint_path=path, checkpoint_interval_batches=1, status_cb=_cut_after(1))
    with pytest.raises(ValueError, match=f"{impl}-tracker checkpoint"):
        run_video(_source(video), video.corners, CFG, CPU, tracker_impl=other,
                  checkpoint_path=path)


@pytest.mark.parametrize("impl", ["host", "device"])
def test_a_source_that_cannot_seek_refuses_to_resume(tmp_path, video, impl):
    cv2 = pytest.importorskip("cv2")
    clip = tmp_path / "clip.avi"
    H, W = video.frames.shape[1:3]
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (W, H))
    for f in video.frames[:42]:
        writer.write(f)
    writer.release()
    src = open_source(clip)
    assert not src.supports_seek and ArraySource(video.frames).supports_seek
    path = tmp_path / "ckpt.json"
    state = checkpoint.source_fingerprint(src)
    if impl == "device":
        checkpoint.save_checkpoint_device(path, 21, 21, _empty_state(), [], src.fps, state)
    else:
        from swiftwatcher_tpu_torch.pipeline.tracking import SegmentTracker

        checkpoint.save_checkpoint(path, 21, 21, SegmentTracker(np.zeros((1, 1))), src.fps, state)
    try:
        with pytest.raises(ValueError, match="sequential source"):
            run_video(src, video.corners, CFG, CPU, tracker_impl=impl, checkpoint_path=path)
    finally:
        src.close()
