"""The port's own host layer vs the JAX package's: config, geometry, the
host tracker, timestamps, run metrics and the classifier's host helpers
(PIL tap weights, canvas packing, bbox expansion) give the same results on
the same inputs.  The port keeps copies of these modules, so these tests are what
holds the copies to the originals."""

import dataclasses

import numpy as np
import pytest

from swiftwatcher_tpu import config as jax_config
from swiftwatcher_tpu import geometry as jax_geometry
from swiftwatcher_tpu.io import export as jax_export
from swiftwatcher_tpu.io import readers as jax_readers
from swiftwatcher_tpu.models import classifier as jax_classifier
from swiftwatcher_tpu.models import preprocess as jax_preprocess
from swiftwatcher_tpu.pipeline import tracking as jax_tracking
from swiftwatcher_tpu.utils import metrics as jax_metrics
from swiftwatcher_tpu_torch import config, geometry
from swiftwatcher_tpu_torch.io import export
from swiftwatcher_tpu_torch.models import classifier, preprocess
from swiftwatcher_tpu_torch.pipeline import tracking
from swiftwatcher_tpu_torch.utils import metrics


def test_config_fields_types_defaults_and_order():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(config.PipelineConfig)]
    theirs = [(f.name, f.type, f.default)
              for f in dataclasses.fields(jax_config.PipelineConfig)]
    assert ours == theirs
    assert dataclasses.asdict(config.DEFAULT_CONFIG) == dataclasses.asdict(
        jax_config.DEFAULT_CONFIG)
    assert config.ACCURACY_PACK_OVERRIDES == jax_config.ACCURACY_PACK_OVERRIDES


@pytest.mark.parametrize("overrides", [
    ["rpca_warm_basis=false", "batch_windows=4"],
    ["opening_size=5,5", "rpca_dtype=float64", "rpca_tol=0.002", "use_pallas_rpca=0"],
    ["mode_valid_range=-120,-60", "wire_codec=off", "rpca_state_bf16=yes"],
    list(jax_config.ACCURACY_PACK_OVERRIDES) + ["stabilize_max_shift=1"],
])
def test_config_with_overrides_same_results(overrides):
    ours = config.config_with_overrides(overrides)
    theirs = jax_config.config_with_overrides(overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_with_overrides_unknown_field_raises():
    for mod in (config, jax_config):
        with pytest.raises(ValueError, match="no_such_field"):
            mod.config_with_overrides(["no_such_field=1"])


def test_geometry_agrees(rng):
    frame = rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8)
    for _ in range(20):
        x = rng.integers(50, 550, size=2)
        y = rng.integers(100, 400, size=2)
        corners = [(int(x[0]), int(y[0])), (int(x[1]), int(y[1]))]
        for name in ("chimney_extents",):
            assert getattr(geometry, name)(corners) == getattr(jax_geometry, name)(corners)
        for name in ("crop_region_from_corners", "roi_crop_region_from_corners"):
            ours = getattr(geometry, name)(corners, config.DEFAULT_CONFIG)
            theirs = getattr(jax_geometry, name)(corners, jax_config.DEFAULT_CONFIG)
            assert ours == theirs
            assert geometry.region_shape(ours) == jax_geometry.region_shape(theirs)
            np.testing.assert_array_equal(geometry.crop_array(frame, ours),
                                          jax_geometry.crop_array(frame, theirs))


def _centroid_stream(rng, n_frames, H, W):
    """Seeded random walks of 0-4 segments per frame, born and lost at
    random, with sub-pixel centroids."""
    tracks, frames = [], []
    for _ in range(n_frames):
        tracks = [(y + dy, x + dx) for (y, x), (dy, dx) in
                  zip(tracks, rng.normal(0, 4, size=(len(tracks), 2)))
                  if 0 <= y + dy < H and 0 <= x + dx < W and rng.random() > 0.1]
        while len(tracks) < 4 and rng.random() < 0.3:
            tracks.append((float(rng.uniform(0, H)), float(rng.uniform(0, W))))
        frames.append(list(tracks))
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_segment_tracker_same_events(seed):
    rng = np.random.default_rng(seed)
    H, W = 120, 160
    roi = np.zeros((H, W), np.uint8)
    roi[40:100, 30:130] = 255
    ours = tracking.SegmentTracker(roi, config.DEFAULT_CONFIG)
    theirs = jax_tracking.SegmentTracker(roi, jax_config.DEFAULT_CONFIG)
    for fn, centroids in enumerate(_centroid_stream(rng, 200, H, W)):
        ours.step(centroids, fn, fn)
        theirs.step(centroids, fn, fn)
    assert len(ours.events) > 0
    assert [dataclasses.astuple(e) for e in ours.events] == [
        dataclasses.astuple(e) for e in theirs.events]


def test_cost_matrix_agrees(rng):
    prev = [tracking.Track(centroid=tuple(rng.uniform(0, 100, 2)), frame_number=0,
                           timestamp=0, hist_len=int(rng.integers(0, 3)),
                           hist_first=tuple(rng.uniform(0, 100, 2))) for _ in range(4)]
    curr = [tracking.Track(centroid=tuple(rng.uniform(0, 100, 2)), frame_number=1,
                           timestamp=1) for _ in range(3)]
    jprev = [jax_tracking.Track(**dataclasses.asdict(t)) for t in prev]
    jcurr = [jax_tracking.Track(**dataclasses.asdict(t)) for t in curr]
    np.testing.assert_array_equal(tracking.build_cost_matrix(prev, curr),
                                  jax_tracking.build_cost_matrix(jprev, jcurr))


@pytest.mark.parametrize("fn, fps", [(0, 30.0), (1, 30.0), (12345, 29.97), (7, 25.0)])
def test_frame_timestamp_agrees(fn, fps):
    assert export.frame_timestamp(fn, fps) == jax_export.frame_timestamp(fn, fps)


def test_null_timestamp_agrees():
    assert export.NULL_TIMESTAMP == jax_readers.NULL_TIMESTAMP


def test_run_metrics_summary_keys():
    ours, theirs = metrics.RunMetrics(), jax_metrics.RunMetrics()
    for m in (ours, theirs):
        m.frames_processed, m.ialm_iters = 42, [14, 15]
        m.stage_start("localize")
        m.stage_stop("localize")
    a, b = ours.summary(), theirs.summary()
    assert a.keys() == b.keys()
    for k in ("frames_processed", "ialm_iters_mean", "ialm_iters_max", "segments_per_frame"):
        assert a[k] == b[k]


@pytest.mark.parametrize("max_in, out", [(64, 24), (32, 24), (64, 7), (5, 24)])
def test_resize_coeffs_agree(max_in, out):
    sizes = np.arange(1, max_in + 1, dtype=np.int32)
    ours = preprocess.resize_coeffs(sizes, max_in, out)
    assert ours.dtype == np.int32 and ours.shape == (max_in, out, max_in)
    np.testing.assert_array_equal(ours, jax_preprocess.resize_coeffs(sizes, max_in, out))


def test_pack_canvases_agree(rng):
    imgs = [rng.integers(0, 256, (int(h), int(w), 3), np.uint8)
            for h, w in rng.integers(1, 33, (9, 2))]
    for a, b in zip(preprocess.pack_canvases(imgs, 32), jax_preprocess.pack_canvases(imgs, 32)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_expand_bbox_agrees(rng):
    for _ in range(100):
        y1, x1 = (int(v) for v in rng.integers(-3, 100, 2))
        box = [y1, x1, y1 + int(rng.integers(0, 30)), x1 + int(rng.integers(0, 30))]
        assert classifier.expand_bbox(box, (24, 24)) == jax_classifier.expand_bbox(box, (24, 24))


# The accuracy corpus's host copies: the port's make_hard_video, the CSV
# round trips, and tools/torch_accuracy_corpus.py's scene table, ground
# truth and scoring, against the JAX package and the JAX-side tools.

def _corpus_tools():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import accuracy_corpus
    import evaluate
    import torch_accuracy_corpus

    return accuracy_corpus, evaluate, torch_accuracy_corpus


def test_corpus_scene_table_equals_the_jax_tools():
    theirs, _, ours = _corpus_tools()
    assert ours.SCENES == theirs.SCENES and list(ours.SCENES) == list(theirs.SCENES)
    assert ours.BASE == theirs.BASE
    assert ours.VARIANTS == theirs.VARIANTS
    assert ours.GT_COLUMNS == _corpus_tools()[1].GT_COLUMNS


@pytest.mark.parametrize("kw", [
    dict(seed=9, n_frames=24, H=120, W=160, n_entering=2, n_vanishing=1, n_crossing=1),
    dict(seed=10, n_frames=24, H=120, W=160, n_entering=3, simultaneous=True, jitter=2,
         noise=6, occluder=True, flicker=0.08, motion_blur=0.6),
])
def test_make_hard_video_agrees(kw):
    from swiftwatcher_tpu.io.synthetic import make_hard_video as jax_make_hard_video
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video

    ours, theirs = make_hard_video(**kw), jax_make_hard_video(**kw)
    np.testing.assert_array_equal(ours.frames, theirs.frames)
    assert dataclasses.asdict(ours).keys() == dataclasses.asdict(theirs).keys()
    assert (ours.corners, ours.fps, ours.entry_frames, ours.n_distractors) == (
        theirs.corners, theirs.fps, theirs.entry_frames, theirs.n_distractors)


def test_groundtruth_csv_and_dataframes_agree(tmp_path):
    import pandas as pd
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video

    theirs_tool, _, ours_tool = _corpus_tools()
    video = make_hard_video(seed=50, n_frames=40, n_entering=2)
    for fps in (None, 29.97):
        ours_tool.groundtruth_csv(video, tmp_path / "ours.csv", fps=fps)
        theirs_tool.groundtruth_csv(video, tmp_path / "theirs.csv", fps=fps)
        assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()
        pd.testing.assert_frame_equal(export.dataframe_from_csv(tmp_path / "ours.csv"),
                                      jax_export.dataframe_from_csv(tmp_path / "ours.csv"))


@pytest.mark.parametrize("granularity", ["exact", "second", "minute", "video"])
def test_corpus_scoring_equals_evaluate(tmp_path, granularity, rng):
    import pandas as pd

    _, evaluate, ours = _corpus_tools()
    fns = np.sort(rng.choice(4000, 40, replace=False))
    stamps = [export.frame_timestamp(int(f), 30.0).strftime("%H:%M:%S.%f") for f in fns]
    pred = pd.DataFrame({"timestamp": stamps, "framenumber": fns,
                         "predicted": rng.integers(0, 2, 40), "rejected": rng.integers(0, 2, 40)})
    gt = pd.DataFrame({"timestamp": stamps[::2], "framenumber": fns[::2],
                       "predicted": rng.integers(0, 3, 20)})
    pred.to_csv(tmp_path / "7-swifts_full_usec.csv", index=False)
    gt.to_csv(tmp_path / "gt.csv", index=False)
    for cols in (("predicted", "rejected"), ("predicted",)):
        a = ours.score_counts(
            ours._count_series(ours.load_results(tmp_path), cols, granularity),
            ours._count_series(ours.load_groundtruth(tmp_path / "gt.csv"), ours.GT_COLUMNS,
                               granularity))
        b = evaluate.score_counts(
            evaluate._count_series(evaluate.load_results(tmp_path), cols, granularity),
            evaluate._count_series(evaluate.load_groundtruth(tmp_path / "gt.csv"),
                                   evaluate.GT_COLUMNS, granularity))
        assert (a.tp, a.fp, a.missed) == (b.tp, b.fp, b.missed)
        assert (a.precision, a.recall, a.f1) == (b.precision, b.recall, b.f1)
        assert ours._fmt_row("x", a) == evaluate._fmt_row("x", b)
