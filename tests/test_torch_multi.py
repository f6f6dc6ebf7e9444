"""The port's multi-video runner (swiftwatcher_tpu_torch/pipeline/multi.py)
vs sequential runs and vs the JAX package's run_videos: three clips of
different geometry (each its own crop), run two or three at a time on
both trackers, give each clip's events, counts and CSVs in job order, and
a job's error surfaces."""

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.pipeline.multi import run_videos as jax_run_videos
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.pipeline.multi import run_videos
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_runner)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def videos():
    return [make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1),
            make_video(seed=1, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1),
            make_video(seed=4, n_frames=42, H=180, W=260, n_entering=1, noise=5)]


def _events(r):
    return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]


def _csvs(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


@pytest.mark.parametrize("tracker, concurrent", [("host", 2), ("device", 2), ("device", 3)])
def test_run_videos_vs_sequential_and_jax(tmp_path, videos, tracker, concurrent):
    jobs = [(ArraySource(v.frames, fps=v.fps), v.corners) for v in videos]
    ours = run_videos(jobs, DEFAULT_CONFIG, CPU, max_concurrent=concurrent,
                      per_video_kwargs=lambda i: dict(export_dir=tmp_path / f"par{i}"),
                      tracker_impl=tracker)
    seq = [run_video(ArraySource(v.frames, fps=v.fps), v.corners, DEFAULT_CONFIG, CPU,
                     export_dir=tmp_path / f"seq{i}", tracker_impl=tracker)
           for i, v in enumerate(videos)]
    theirs = jax_run_videos([(JaxArraySource(v.frames, fps=v.fps), v.corners) for v in videos],
                            JAX_CONFIG, max_concurrent=concurrent, tracker_impl="host")
    assert len(ours) == len(videos)
    for i, (a, b, c) in enumerate(zip(ours, seq, theirs)):
        assert _events(a) == _events(b)
        assert [e.frame_number for e in a.events] == [e.frame_number for e in c.events]
        assert (a.total_predicted, a.total_rejected, a.frames_processed) == (
            b.total_predicted, b.total_rejected, b.frames_processed) == (
            c.total_predicted, c.total_rejected, c.frames_processed)
        assert _csvs(tmp_path / f"par{i}") == _csvs(tmp_path / f"seq{i}")
    assert [r.total_predicted for r in ours[:2]] == [v.n_entering for v in videos[:2]]


def test_a_failing_job_raises(videos):
    good = (ArraySource(videos[0].frames, fps=30.0), videos[0].corners)
    bad = (ArraySource(videos[1].frames, fps=30.0), videos[1].corners)
    with pytest.raises(ValueError, match="tracker_impl"):
        run_videos([good, bad], DEFAULT_CONFIG, CPU,
                   per_video_kwargs=lambda i: dict(tracker_impl="host" if i == 0 else "gpu"))
