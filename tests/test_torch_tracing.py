"""The port's spans and counters (utils/metrics.py): each is booked where
its work happens, once a batch or once a trip as documented, into the run
bound on the calling thread, and under a profiler it is a range of the
trace by the same name.  The spans change no result: the events and totals
stay the JAX package's."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.io.synthetic import make_video
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_hard_video
from swiftwatcher_tpu_torch.models import squeezenet
from swiftwatcher_tpu_torch.models.classifier import SqueezeNetSegmentFilter
from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched
from swiftwatcher_tpu_torch.pipeline.multi import run_videos
from swiftwatcher_tpu_torch.pipeline.runner import run_video
from swiftwatcher_tpu_torch.utils import metrics

CPU = torch.device("cpu")
# three windows of 21 frames in batches of two: a full batch and a padded one
SCENE = dict(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
BATCH = 2
SYNCS = ("sync.ialm_stop", "sync.ialm_eigh", "sync.ccl_flag", "sync.props_max",
         "sync.props_bincount", "sync.consume_iters", "sync.consume_events")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return dataclasses.replace(DEFAULT_CONFIG, batch_windows=BATCH, **kw)


def _run(video, cfg, **kw):
    return run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                     tracker_impl="device", **kw)


def _batch_trips(iters):
    """The batched loop's trips: the most of each batch's windows' counts."""
    return sum(max(iters[i:i + BATCH]) for i in range(0, len(iters), BATCH))


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The device tracker on SCENE in batches of two, profiled: (result,
    the trace's event names)."""
    prof = tmp_path_factory.mktemp("prof")
    res = _run(make_video(**SCENE), _cfg(), profile_dir=prof)
    trace = json.loads((prof / "trace.json").read_text())
    return res, {e.get("name") for e in trace["traceEvents"]}


def test_ialm_stop_reads_count_each_batch_loop_trip(profiled):
    """The batched loop reads its stop flag before each trip and once to
    end: it runs as many trips as the slowest of the batch's windows."""
    res, _ = profiled
    m = res.metrics
    assert m.batches == 2 and len(res.ialm_iters) == 3
    trips = _batch_trips(res.ialm_iters)
    assert m.counters["sync.ialm_stop"] == trips + m.batches
    assert trips > sum(res.ialm_iters) / 3 * m.batches > 0


def test_sync_spans_count_each_read(profiled):
    """A stop-flag read before each trip and one that ends the loop; an
    eigh a warm trip and the seed's a batch; a bincount each of the row and
    column counts; one read each a batch of the flagged frames, the label
    maximum, the IALM counts and the events."""
    res, _ = profiled
    c, batches = res.metrics.counters, res.metrics.batches
    trips = _batch_trips(res.ialm_iters)
    assert c["sync.ialm_stop"] == trips + batches
    assert c["sync.ialm_eigh"] == trips + batches
    assert c["sync.props_bincount"] == 2 * batches
    for name in ("sync.ccl_flag", "sync.props_max", "sync.consume_iters",
                 "sync.consume_events"):
        assert c[name] == batches, name
    assert set(n for n in c if n.startswith("sync.")) == set(SYNCS)
    for name in SYNCS:
        assert res.metrics.stage_seconds[name] >= 0.0


@pytest.mark.parametrize("name, parent", [("ialm_solve", "localize"),
                                          ("sync.ccl_flag", "localize"),
                                          ("sync.consume_iters", "consume")])
def test_nested_spans_fit_in_their_parent(profiled, name, parent):
    st = profiled[0].metrics.stage_seconds
    assert 0.0 < st[name] <= st[parent]


def test_runner_spans_count_once_a_batch(profiled):
    res, _ = profiled
    c, batches = res.metrics.counters, res.metrics.batches
    for name in ("localize", "track_dispatch", "consume", "ialm_solve",
                 "prefetch_read", "prefetch_upload"):
        assert c[name] == batches, name
    # the loop's last wait finds the video done
    assert c["prefetch_wait"] == batches + 1
    assert "stabilize" not in c
    for name in ("prefetch_read", "prefetch_upload", "prefetch_wait"):
        assert name in res.metrics.stage_seconds


def test_a_run_without_a_filter_has_no_classify_forward(profiled):
    res, names = profiled
    assert "classify_forward" not in res.metrics.counters
    assert "classify_forward" not in names


# the segment filter's paths: the tracker and the configuration they take
FILTER_PATHS = {"fused": ("device", dict(classify_fused=True)),
                "unfused": ("device", dict(classify_fused=False)),
                "host_pil": ("device", dict(classify_fused=False, cnn_device_preprocess=False)),
                "host_tracker": ("host", {})}


@pytest.mark.parametrize("path", sorted(FILTER_PATHS))
def test_classify_forward_counts_once_a_forward(path, tmp_path, monkeypatch):
    """The forward and its argmax are one classify_forward span and range
    on every classify path (96-pixel inputs keep the CPU's forwards short)."""
    impl, kw = FILTER_PATHS[path]
    forwards = []
    real = squeezenet.forward

    def forward(params, x):
        forwards.append(len(x))
        return real(params, x)

    monkeypatch.setattr(squeezenet, "forward", forward)
    cfg = _cfg(cnn_input_size=96, **kw)
    video = make_video(**SCENE)
    res = run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU,
                    tracker_impl=impl, profile_dir=tmp_path / "prof",
                    segment_filter=SqueezeNetSegmentFilter.from_default_weights(cfg, CPU))
    m = res.metrics
    assert len(forwards) >= m.batches == 2 and sum(forwards) >= m.segments_total > 0
    assert m.counters["classify_forward"] == len(forwards)
    # the fused path's range, classify_track_fused, holds its forwards
    assert ("classify_device" in m.counters) == (path == "fused")
    assert 0.0 < m.stage_seconds["classify_forward"] <= m.stage_seconds["consume"]
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ranges = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name") == "classify_forward"]
    assert len(ranges) == len(forwards)


def test_counters_stay_out_of_the_manifest(profiled):
    summary = profiled[0].metrics.summary()
    assert "counters" not in summary
    assert set(summary["device_stage_seconds"]) == {"localize", "track_scan"}


def test_profile_trace_names_the_spans(profiled):
    _, names = profiled
    assert {"localize_dispatch", "track_dispatch", "consume", "prefetch_wait",
            "ialm_solve", *SYNCS} <= names
    # the runner's localize span is named localize_dispatch in the trace
    assert "localize" not in names


def test_spanned_run_keeps_the_jax_events(profiled):
    res, _ = profiled
    video = make_video(**SCENE)
    theirs = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                           dataclasses.replace(JAX_CONFIG, batch_windows=BATCH),
                           tracker_impl="host")
    assert [e.frame_number for e in res.events] == [e.frame_number for e in theirs.events]
    # the device tracker keeps f32 centroids, the host tracker f64
    np.testing.assert_allclose([e.first_centroid + e.last_centroid for e in res.events],
                               [e.first_centroid + e.last_centroid for e in theirs.events],
                               rtol=0, atol=1e-3)
    assert (res.total_predicted, res.total_rejected) == (
        theirs.total_predicted, theirs.total_rejected) == (video.n_entering, video.n_vanishing)


def test_stabilize_span_once_a_batch():
    video = make_hard_video(seed=49, n_entering=3, jitter=2, n_frames=63)
    res = _run(video, _cfg(stabilize_max_shift=3))
    c = res.metrics.counters
    assert c["stabilize"] == res.metrics.batches == 2
    assert 0.0 < res.metrics.stage_seconds["stabilize"] <= res.metrics.stage_seconds["localize"]
    assert res.events


def test_fixed_trip_solver_reads_no_stop_flag():
    res = _run(make_video(**SCENE), _cfg(rpca_fixed_iters=3))
    c = res.metrics.counters
    assert res.ialm_iters == [3] * 3
    assert "sync.ialm_stop" not in c
    assert c["sync.ialm_eigh"] == 4 * res.metrics.batches


def test_track_dispatch_once_a_batch_on_the_export_path(tmp_path):
    """With frames kept (the export here, a segment filter alike) the scan
    is dispatched in consume: one track_dispatch span and range a batch."""
    video = make_video(**SCENE)
    res = _run(video, _cfg(), export_segments_dir=tmp_path / "segs",
               profile_dir=tmp_path / "prof")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ranges = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name") == "track_dispatch"]
    assert res.metrics.counters["track_dispatch"] == len(ranges) == res.metrics.batches
    assert res.metrics.stage_seconds["track_dispatch"] <= res.metrics.stage_seconds["consume"]


def _window_batch():
    video = make_video(**SCENE)
    return torch.from_numpy(video.frames[:21, :40, :48, 1].copy())[None]


def test_ops_book_into_the_bound_run_only():
    gray = _window_batch()
    run = metrics.RunMetrics()
    _, iters = rpca_motion_window_batched(gray, DEFAULT_CONFIG)
    assert run.counters == {} and run.stage_seconds == {}
    with metrics.bind(run):
        rpca_motion_window_batched(gray, DEFAULT_CONFIG)
        with metrics.bind(None):
            rpca_motion_window_batched(gray, DEFAULT_CONFIG)
    trips = int(iters[0])
    assert run.counters["ialm_solve"] == 1
    assert run.counters["sync.ialm_stop"] == trips + 1
    assert run.counters["sync.ialm_eigh"] == trips + 1
    # bind restores the binding it found
    with metrics.span("sync.after_bind"):
        pass
    assert "sync.after_bind" not in run.counters


def test_unbound_span_still_opens_the_trace_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with metrics.span("sync.unbound_probe"):
            torch.ones(4).sum()
    assert "sync.unbound_probe" in {e.key for e in prof.key_averages()}


def test_span_books_seconds_count_and_trace_name():
    run = metrics.RunMetrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with run.span("localize", trace_name="localize_dispatch"):
                pass
    assert run.counters == {"localize": 3}
    assert run.stage_seconds["localize"] >= 0.0
    keys = {e.key for e in prof.key_averages()}
    assert "localize_dispatch" in keys and "localize" not in keys
    # a span that raises still books its seconds
    with pytest.raises(RuntimeError):
        with run.span("consume"):
            raise RuntimeError("boom")
    assert run.counters["consume"] == 1 and "consume" in run.stage_seconds


def test_bindings_are_per_thread():
    """Eight threads, half bound to each of two runs, each booking names of
    its own, as the runner and its prefetch worker share one run: no span
    is lost or lands in the other run."""
    import sys

    runs = [metrics.RunMetrics(), metrics.RunMetrics()]
    ready = threading.Barrier(8, timeout=30)

    def work(i):
        with metrics.bind(runs[i % 2]):
            ready.wait()
            for _ in range(500):
                with metrics.span(f"sync.probe{i}"):
                    with metrics.span(f"inner{i}"):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k, run in enumerate(runs):
        mine = range(k, 8, 2)
        names = {f"sync.probe{i}" for i in mine} | {f"inner{i}" for i in mine}
        assert run.counters == dict.fromkeys(names, 500)
        assert set(run.stage_seconds) == names


def test_run_videos_keep_separate_counters():
    videos = [make_video(**SCENE),
              make_video(seed=1, n_frames=105, n_entering=2, n_crossing=1, n_vanishing=1)]
    jobs = [(ArraySource(v.frames, fps=v.fps), v.corners) for v in videos]
    results = run_videos(jobs, _cfg(), CPU, max_concurrent=2, tracker_impl="device")
    assert [r.metrics.batches for r in results] == [2, 3]
    for r in results:
        c = r.metrics.counters
        assert c["localize"] == c["prefetch_read"] == r.metrics.batches
        assert c["sync.ialm_stop"] == _batch_trips(r.ialm_iters) + r.metrics.batches


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_sync_audit_attributes_each_blocking_call():
    """tools/torch_sync_audit.py on a hand-made trace of one batch: a sync
    call inside a sync. range, one outside any, one on another thread; the
    card busy 10-40 and 50-55 of the main thread's 0-100."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_sync_audit

    events = [
        _x("user_annotation", "localize_dispatch", 0, 100),
        _x("user_annotation", "ialm_solve", 5, 45),
        _x("user_annotation", "sync.ialm_stop", 20, 10),
        _x("cuda_runtime", "cudaStreamSynchronize", 25, 4),
        _x("cuda_runtime", "cudaMemcpy", 60, 2),
        _x("cuda_runtime", "cudaStreamSynchronize", 70, 2, tid=9),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("kernel", "gemm", 10, 30, tid=7, correlation=1),
        _x("gpu_memcpy", "copy", 50, 5, tid=7),
    ]
    out = torch_sync_audit.audit_events(events, batches=1)
    assert out["sync_calls_per_batch"] == {"sync.ialm_stop": 1, "outside localize_dispatch": 1}
    assert out["sync_ranges_per_batch"] == 1
    r = out["ranges"]
    assert r["localize_dispatch"]["wall_ms"] == pytest.approx(0.1)
    assert r["localize_dispatch"]["idle_pct"] == pytest.approx(65.0)
    assert r["ialm_solve"]["idle_pct"] == pytest.approx(100.0 * 15 / 45)
    assert r["sync.ialm_stop"]["idle_pct"] == pytest.approx(0.0)
    assert r["ialm_solve"]["kernel_ms"] == pytest.approx(0.03)
