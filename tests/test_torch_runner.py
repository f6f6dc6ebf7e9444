"""Port vs JAX package end to end: run_video on the scenes of
tests/test_end_to_end.py, with the warm-basis and the cold-start solver.
Events (frame numbers and centroids), predicted and rejected counts, and
ground truth are equal; exported CSVs are byte-equal.  Each package runs
with its own DEFAULT_CONFIG."""

import dataclasses

import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.io.synthetic import make_video
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")

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


@pytest.mark.parametrize("kw", [
    {"tracker_impl": "device"}, {"mesh": object()}, {"segment_filter": object()},
    {"checkpoint_path": "ckpt"}, {"profile_dir": "prof"}, {"export_segments_dir": "seg"},
])
def test_unported_options_raise(kw):
    video = make_video(seed=0, n_frames=21, n_entering=0, n_crossing=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                  DEFAULT_CONFIG, CPU, **kw)


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
