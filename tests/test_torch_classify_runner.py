"""--classify end to end: the port's run_video with a segment filter against
the JAX package's, on the CPU.

Each scene runs with the shipped weights, with a split weight set and with
a deterministic filter, through the port's three classify paths (the host
tracker's batch_call, the device tracker fused and unfused) and through
the JAX package's host tracker with the same weights: events one for one,
equal totals and equal segments_total.  The shipped weights keep every
segment of these scenes, so a port that ignored the keep-mask would pass
with them alone.  Two weight sets lower classifier.1.bias[1] (BIASES):
"split" rejects about half the segments (8 of 15 and 20 of 35), which
leaves no event, and "partial" rejects fewer (2 of 15 and 10 of 35), which
moves the events (the seed-3 scene's 3 / 1 becomes 3 / 0), so where each
keep bit lands shows in the events.  No segment's |logit1 - logit0| is
below 1e-3 under either (smallest 0.026), so the CPU's and the card's
rounding cannot flip a decision.
Also: reject-all and keep-all, the oversized-crop fallback, checkpoint and
resume with classify on both trackers, event order when a fused batch is
followed by one without segments, and the device tracker with a filter
that has no batch_call and with the export: it keeps its own scan."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.models.classifier import SqueezeNetSegmentFilter as JaxFilter
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.models.classifier import DEFAULT_WEIGHTS, SqueezeNetSegmentFilter
from swiftwatcher_tpu_torch.models.squeezenet import params_from_jax
from swiftwatcher_tpu_torch.pipeline import runner as runner_mod
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")
# classifier.1.bias[1] of the shipped weights is -0.0086; these values
# reject part of the scenes' segments (see the module docstring)
BIASES = {"split": -200.0, "partial": -150.0}
WEIGHTS = ["shipped", "split", "partial"]

SCENES = {
    "small": dict(seed=0, n_frames=63, n_entering=2, n_crossing=1),
    "seed3": dict(seed=3, n_frames=126, n_entering=3, n_crossing=2, n_vanishing=1),
}
PATHS = {
    "host": ("host", True),
    "fused": ("device", True),
    "unfused": ("device", False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on one host, and torch's default of a thread
    per core makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(name):
    with np.load(DEFAULT_WEIGHTS) as data:
        params = {k: data[k].copy() for k in data.files}
    if name in BIASES:
        params["classifier.1.bias"][1] = BIASES[name]
    return params


class EvenRejector:
    """A batchable filter that rejects even-indexed segments; __call__ and
    batch_call agree by construction."""

    def __call__(self, table, index, frame, crop_region):
        b, t = index
        assert frame is not None
        n = int(np.asarray(table.valid[b, t]).sum())
        return [i % 2 == 1 for i in range(n)]

    def batch_call(self, table, frames, crop_region, timers=None):
        return {key: self(table, key, frames[key], crop_region) for key in frames}


class PerFrameOnly(EvenRejector):
    """The same predicate without batch_call."""

    def __getattribute__(self, name):
        if name == "batch_call":
            raise AttributeError(name)
        return super().__getattribute__(name)


class Constant(EvenRejector):
    def __init__(self, value):
        self.value = value

    def __call__(self, table, index, frame, crop_region):
        b, t = index
        return [self.value] * int(np.asarray(table.valid[b, t]).sum())


def _events(result):
    return [(e.frame_number, e.first_centroid, e.last_centroid) for e in result.events]


@pytest.fixture(scope="module")
def videos():
    return {name: make_video(**kw) for name, kw in SCENES.items()}


def _filter(weights):
    return SqueezeNetSegmentFilter(params_from_jax(_weights(weights)), DEFAULT_CONFIG, CPU)


def _run(video, segment_filter, path="host", cfg=DEFAULT_CONFIG, **kw):
    impl, fused = PATHS[path]
    return run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                     dataclasses.replace(cfg, classify_fused=fused), CPU,
                     tracker_impl=impl, segment_filter=segment_filter, **kw)


def _jax_run(video, segment_filter):
    return jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                         JAX_CONFIG, tracker_impl="host", segment_filter=segment_filter)


@pytest.fixture(scope="module")
def jax_results(videos):
    out = {}
    for scene, video in videos.items():
        for weights in WEIGHTS:
            out[scene, weights] = _jax_run(video, JaxFilter(_weights(weights), JAX_CONFIG))
        out[scene, "even"] = _jax_run(video, EvenRejector())
    return out


@pytest.fixture(scope="module")
def port_results(videos):
    filters = {w: _filter(w) for w in WEIGHTS}
    filters["even"] = EvenRejector()
    return {(scene, weights, path): _run(video, filters[weights], path)
            for scene, video in videos.items() for weights in filters for path in PATHS}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("weights", WEIGHTS + ["even"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_classify_vs_jax(jax_results, port_results, scene, weights, path):
    ours, theirs = port_results[scene, weights, path], jax_results[scene, weights]
    assert _events(ours) == _events(theirs)
    assert ours.total_predicted == theirs.total_predicted
    assert ours.total_rejected == theirs.total_rejected
    assert ours.metrics.segments_total == theirs.metrics.segments_total
    assert ours.frames_processed == theirs.frames_processed


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_split_weights_reject_about_half(jax_results, port_results, scene):
    """The split set rejects 30-70% of the segments the shipped set keeps
    (it keeps them all)."""
    kept = {w: port_results[scene, w, "fused"].metrics.segments_total
            for w in ("shipped", "split")}
    assert 0.3 * kept["shipped"] <= kept["split"] <= 0.7 * kept["shipped"]
    assert jax_results[scene, "split"].metrics.segments_total == kept["split"]


def test_partial_weights_move_the_events(port_results):
    """The partial set keeps events, and they differ from the shipped
    set's: the keep-mask's placement is visible in the events."""
    for scene in SCENES:
        assert port_results[scene, "partial", "fused"].events
    assert any(_events(port_results[s, "partial", "fused"])
               != _events(port_results[s, "shipped", "fused"]) for s in SCENES)


def test_classify_metrics_carry_the_stage_timers(port_results):
    for path in PATHS:
        stages = port_results["small", "split", path].metrics.stage_seconds
        assert {"classify_crop", "classify_pack", "classify_device"} <= set(stages)
        if path != "host":
            assert "classify_readback" in stages


@pytest.mark.parametrize("path", sorted(PATHS))
def test_reject_all_gives_no_events(videos, path):
    res = _run(videos["small"], Constant(False), path)
    assert res.events == [] and res.total_predicted == 0
    assert res.metrics.segments_total == 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_keep_all_equals_no_filter(videos, path):
    video = videos["small"]
    impl, _ = PATHS[path]
    plain = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                      DEFAULT_CONFIG, CPU, tracker_impl=impl)
    kept = _run(video, Constant(True), path)
    assert _events(kept) == _events(plain) and len(plain.events) > 0
    assert kept.total_predicted == plain.total_predicted
    assert kept.total_rejected == plain.total_rejected


def test_fused_oversized_crop_takes_the_unfused_path(videos, port_results, monkeypatch):
    """A crop larger than every device canvas makes pack_fused return None;
    the batch then goes through batch_call, whose classify_images takes
    host PIL: the same events as the fused run."""
    calls = []
    real = SqueezeNetSegmentFilter.batch_call

    def counting(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(SqueezeNetSegmentFilter, "_canvas_bucket", lambda self, images: 0)
    monkeypatch.setattr(SqueezeNetSegmentFilter, "batch_call", counting)
    res = _run(videos["small"], _filter("split"), "fused")
    base = port_results["small", "split", "fused"]
    assert calls
    assert _events(res) == _events(base)
    assert res.metrics.segments_total == base.metrics.segments_total


class Cut(Exception):
    pass


def _cut_after(k):
    seen = []

    def status(done, total):
        seen.append(done)
        if len(seen) == k:
            raise Cut

    return status


@pytest.mark.parametrize("path", sorted(PATHS))
def test_checkpoint_resume_with_classify(tmp_path, videos, path):
    """One window a batch, so checkpoints land between a dispatch and its
    consume; on the fused path the checkpoint also drains the deferred
    event buffer first."""
    video = videos["small"]
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1)
    segment_filter = _filter("partial")
    full = _run(video, segment_filter, path, cfg)
    ck = tmp_path / "ckpt.json"
    with pytest.raises(Cut):
        _run(video, segment_filter, path, cfg, checkpoint_path=ck,
             checkpoint_interval_batches=1, status_cb=_cut_after(2))
    assert ck.exists()
    resumed = _run(video, segment_filter, path, cfg, checkpoint_path=ck)
    assert _events(resumed) == _events(full) and len(full.events) > 0
    assert resumed.total_predicted == full.total_predicted
    assert resumed.total_rejected == full.total_rejected


@pytest.mark.parametrize("path", sorted(PATHS))
def test_events_stay_in_order_after_a_window_without_segments(path):
    """One window a batch: window 0 holds a swift that leaves inside it and
    one still there at its last frame; window 1 has no segments, and that
    swift's event is emitted there.  The fused path defers window 0's
    events, and window 1's must not overtake them: the order is the JAX
    host tracker's."""
    video = make_video(**SCENES["seed3"])
    sky = make_video(**{**SCENES["seed3"], "n_entering": 0, "n_crossing": 0,
                        "n_vanishing": 0})
    frames = np.concatenate([video.frames[:16], video.frames[29:34], sky.frames[34:55],
                             video.frames[42:63]])
    weights = _weights("shipped")
    theirs = jax_run_video(JaxArraySource(frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, batch_windows=1),
                           tracker_impl="host", segment_filter=JaxFilter(weights, JAX_CONFIG))
    ours = run_video(ArraySource(frames, fps=video.fps), video.corners,
                     dataclasses.replace(DEFAULT_CONFIG, batch_windows=1,
                                         classify_fused=PATHS[path][1]), CPU,
                     tracker_impl=PATHS[path][0],
                     segment_filter=SqueezeNetSegmentFilter(params_from_jax(weights),
                                                            DEFAULT_CONFIG, CPU))
    assert [e.frame_number for e in theirs.events] == [13, 20, 53]
    assert _events(ours) == _events(theirs)


def test_fused_path_packs_the_next_batch_while_the_card_classifies(videos, monkeypatch):
    """One window a batch: consume queues batch k's forward and then packs
    batch k+1's crops, before batch k's status callback; the events and
    kept count stay the unfused path's."""
    video = videos["seed3"]
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1)
    segment_filter = _filter("partial")
    unfused = _run(video, segment_filter, "unfused", cfg)
    done, packed_at = [], []
    real = runner_mod.pack_fused

    def pack_fused(*a, **kw):
        packed_at.append(len(done))
        return real(*a, **kw)

    monkeypatch.setattr(runner_mod, "pack_fused", pack_fused)
    fused = _run(video, segment_filter, "fused", cfg, status_cb=lambda *a: done.append(a))
    assert len(done) == fused.metrics.batches == 6
    assert packed_at == [0] + list(range(len(packed_at) - 1)) and len(packed_at) >= 3
    assert fused.metrics.counters["classify_readback"] == fused.metrics.batches
    assert _events(fused) == _events(unfused) and len(fused.events) > 0
    assert fused.metrics.segments_total == unfused.metrics.segments_total


def _count_scans(monkeypatch):
    """Count the device tracker's track_window calls in the runner."""
    calls = []
    real = runner_mod.track_window

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(runner_mod, "track_window", counting)
    return calls


def test_device_tracker_keeps_its_scan_for_a_per_frame_filter(videos, jax_results,
                                                              monkeypatch):
    """A filter without batch_call is called per frame on the compacted
    tables: no warning, no host tracker, the JAX host tracker's events."""
    video = videos["small"]
    scans = _count_scans(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                        DEFAULT_CONFIG, CPU, tracker_impl="device",
                        segment_filter=PerFrameOnly())
    assert len(scans) == res.metrics.batches > 0
    assert res.frames_processed == 63
    assert _events(res) == _events(jax_results["small", "even"])
    assert res.metrics.segments_total == jax_results["small", "even"].metrics.segments_total


@pytest.mark.parametrize("weights", [None, "split", "partial"])
def test_device_tracker_keeps_its_scan_for_the_export(tmp_path, videos, monkeypatch, weights):
    """--export on the device tracker writes the host tracker's PNGs from
    the read-back compacted planes, with and without a filter."""
    video = videos["small"]
    host = _run(video, weights and _filter(weights), "host", export_segments_dir=tmp_path / "host")
    scans = _count_scans(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dev = _run(video, weights and _filter(weights), "fused",
                   export_segments_dir=tmp_path / "dev")
    assert len(scans) == dev.metrics.batches > 0
    assert _events(dev) == _events(host)
    assert dev.metrics.segments_total == (0 if weights is None else host.metrics.segments_total)
    names = sorted(p.relative_to(tmp_path / "host") for p in (tmp_path / "host").rglob("*.png"))
    assert names and names == sorted(
        p.relative_to(tmp_path / "dev") for p in (tmp_path / "dev").rglob("*.png"))
    for n in names:
        assert (tmp_path / "host" / n).read_bytes() == (tmp_path / "dev" / n).read_bytes()
