"""bench_torch.py and tools/torch_soak.py against bench.py and the JAX
package, on the CPU at a small size (the 240 x 320 make_video(seed=0)
scene, two-window batches): the windows bit-equal to bench.py's, the
resident pass's tables and iterations equal to the JAX package's
localize_windows_gray, the resident-tracked pass's events equal to the
JAX tracking scan's, main()'s two lines with the JAX run_video's counts,
the from-container counts on H.264 and mp4v, no fallback to the CPU, the
watchdog, and the soak's exact count scaling."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.geometry import crop_region_from_corners, roi_crop_region_from_corners
from swiftwatcher_tpu.io.synthetic import LoopingArraySource as JaxLooping
from swiftwatcher_tpu.io.synthetic import make_video as jax_make_video
from swiftwatcher_tpu.ops.roi_mask import generate_roi_mask as jax_roi_mask
from swiftwatcher_tpu.pipeline import tracking_jax
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu.pipeline.window import localize_windows_gray as jax_localize
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io import native_av
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import bench_torch  # noqa: E402
import torch_soak  # noqa: E402

CPU = torch.device("cpu")
SCENE = dict(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
B = 2
T = DEFAULT_CONFIG.window_size
SMALL_ARGS = ["--height", "240", "--width", "320", "--frames", "84", "--warmup-frames", "42",
              "--batch-windows", str(B), "--resident-frames", "42", "--sharded-frames", "42",
              "--container-loops", "2", "--device", "cpu"]
# bench.py's stdout keys, in its order, less vs_baseline and resident_vs_baseline
# (ratios to a TPU target)
STDOUT_KEYS = ["metric", "value", "unit", "e2e_median", "classified_frames_per_sec",
               "resident_frames_per_sec", "resident_tracked_frames_per_sec",
               "resident_tracked_fixed_rpca_frames_per_sec", "sharded_resident_frames_per_sec",
               "sharded_mesh", "e2e_from_container_fps", "note"]
RATES = [k for k in STDOUT_KEYS if k.endswith(("per_sec", "_fps")) or k in ("value",
                                                                             "e2e_median")]
# bench.py's detail keys
DETAIL_KEYS = ["backend", "device", "frames", "elapsed_s", "e2e_samples_fps",
               "classified_samples_fps", "classified_predicted", "classified_stage_seconds",
               "classified_upload_bytes", "e2e_from_container_fps",
               "from_container_counts_equal", "from_container_backend",
               "from_container_samples_fps", "events", "predicted", "batch_windows",
               "host_decode_fps_1080p", "host_decode_backend", "host_cores",
               "crop_bytes_per_frame", "wire_bytes_per_frame", "e2e_wire_MBps"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bench_jax(tmp_path_factory):
    """bench.py as a module.  Its import points JAX's persistent compile
    cache at $SWTPU_COMPILE_CACHE: here a temporary directory, and the
    process's setting is put back right after."""
    before = jax.config.jax_compilation_cache_dir
    old_env = os.environ.get("SWTPU_COMPILE_CACHE")
    os.environ["SWTPU_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("xla_cache"))
    try:
        spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        if old_env is None:
            os.environ.pop("SWTPU_COMPILE_CACHE", None)
        else:
            os.environ["SWTPU_COMPILE_CACHE"] = old_env
    return mod


@pytest.fixture(scope="module")
def scenes():
    return make_video(**SCENE), jax_make_video(**SCENE)


def _cfgs(**kw):
    return (dataclasses.replace(DEFAULT_CONFIG, **kw), dataclasses.replace(JAX_CONFIG, **kw))


@pytest.mark.parametrize("to_gray,w_use,b", [(True, None, 3), (False, None, 3),
                                             (False, 64, 3), (True, None, 24)])
def test_window_batch_bit_equal_to_bench(bench_jax, scenes, to_gray, w_use, b):
    """The same shifted starts (24 slots wrap around the clip), the same
    gray, the same width cut."""
    cfg, jcfg = _cfgs(batch_windows=b)
    ours = bench_torch._window_batch(cfg, scenes[0], to_gray, CPU, w_use=w_use)
    theirs = np.asarray(bench_jax._window_batch(jcfg, scenes[1], to_gray, w_use=w_use))
    assert ours.device == CPU and ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _jax_sums(table, iters):
    fields = (table.area, table.sum_y, table.sum_x, table.valid)
    return [sum(int(np.asarray(f).astype(np.int64).sum()) for f in fields),
            int(np.asarray(iters).astype(np.int64).sum())]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resident_tables_and_iterations_equal_jax(bench_jax, scenes, dtype):
    """The resident pass's program on bench.py's batch gives the JAX
    package's tables, bit for bit, and its iterations: equal in f64 (JAX
    under x64), within 1 with the shipped f32 solver, whose stopping test
    sums in another order in each framework (PARITY deviations 3 and 8,
    tests/test_torch_rpca.py's envelope).  The timed loop's checksum is
    that batch's, once per timed call."""
    cfg, jcfg = _cfgs(batch_windows=B, rpca_dtype=dtype)
    batch = bench_torch._window_batch(cfg, scenes[0], True, CPU)
    table, iters = localize_windows_gray(batch, cfg)
    with jax.enable_x64(dtype == "float64"):
        jtable, jiters = jax_localize(bench_jax._window_batch(jcfg, scenes[1], True), jcfg)
        jtable, jiters = jax.tree.map(np.asarray, jtable), np.asarray(jiters)
    for f in dataclasses.fields(table):
        np.testing.assert_array_equal(getattr(table, f.name).numpy(), getattr(jtable, f.name),
                                      err_msg=f.name)
    assert table.valid.any()
    if dtype == "float64":
        np.testing.assert_array_equal(iters.numpy(), jiters)
    else:
        assert np.abs(iters.numpy().astype(int) - jiters).max() <= 1
    timing = bench_torch.resident_fps(cfg, scenes[0], CPU, frames=3 * B * T)
    assert timing["batches"] == 3 and timing["frames"] == 3 * B * T and timing["fps"] > 0
    assert timing["sums"] == [3 * _jax_sums(jtable, jiters)[0], 3 * int(iters.sum())]
    assert timing["device_fps"] is None and timing["peak_mib"] is None   # no card, no device time


@pytest.mark.parametrize("fixed", [0, 15], ids=["dynamic", "fixed15"])
def test_resident_tracked_events_equal_jax(bench_jax, scenes, fixed):
    """Localisation, compact_tables and the tracking scan over three timed
    batches from an empty tracker, the state carried between them: the
    same events as the JAX package's chain (bench.py's resident_tracked
    body), and the same table sums and iterations."""
    cfg, jcfg = _cfgs(batch_windows=B, rpca_fixed_iters=fixed)
    n = 3
    timing = bench_torch.resident_tracked_fps(cfg, scenes[0], CPU, frames=n * B * T)

    video = scenes[1]
    crop_region = crop_region_from_corners(video.corners, jcfg)
    roi = jnp.asarray(np.asarray(jax_roi_mask(
        video.frames[0], roi_crop_region_from_corners(video.corners, jcfg), crop_region, jcfg)))
    table, iters = jax_localize(bench_jax._window_batch(jcfg, video, True), jcfg)
    cy, cx, kvalid, _ = tracking_jax.compact_tables(table, jcfg.max_tracks)
    fns = jnp.arange(B * T, dtype=jnp.int32)
    active = jnp.ones((B * T,), bool)
    st = tracking_jax.empty_state(jcfg.max_tracks)
    events = 0
    for _ in range(n):
        st, ev = tracking_jax.track_window(
            st, roi, cy.reshape(B * T, -1), cx.reshape(B * T, -1), kvalid.reshape(B * T, -1),
            fns, jcfg, active=active)
        events += int(ev.count)
    assert events > 0
    tables, iterations = _jax_sums(table, iters)
    assert timing["sums"][0] == n * tables and timing["sums"][2] == events
    # iterations within 1 a window (see the test above)
    assert abs(timing["sums"][1] - n * iterations) <= n * B


def test_sharded_resident_equals_the_unsharded_pass(scenes):
    """The mesh path on a (1, 1) gloo mesh, BGR windows grayed on the
    device: the resident pass's checksum; the mesh is closed after."""
    cfg, _ = _cfgs(batch_windows=B)
    timing, shape = bench_torch.sharded_resident_fps(cfg, scenes[0], CPU, frames=2 * B * T)
    resident = bench_torch.resident_fps(cfg, scenes[0], CPU, frames=2 * B * T)
    assert shape == (1, 1)
    assert timing["sums"] == resident["sums"] and timing["batches"] == 2
    assert not torch.distributed.is_initialized()


def test_main_prints_bench_lines_with_the_jax_counts(capsys, scenes):
    """One stdout line with bench.py's keys (less its TPU ratios) in its
    order, every rate positive, then the detail line on stderr; its
    predicted, rejected and events are the JAX run_video's with the device
    tracker over the same frames."""
    assert bench_torch.main(SMALL_ARGS) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == STDOUT_KEYS
    assert all(line[k] > 0 for k in RATES), {k: line[k] for k in RATES}
    assert line["sharded_mesh"] == [1, 1] and line["unit"] == "frames/sec"
    details = [json.loads(s) for s in err.splitlines() if s.startswith('{"detail"')]
    assert len(details) == 1
    d = details[0]["detail"]
    assert set(DETAIL_KEYS) <= set(d)
    assert {"card", "torch", "cuda", "predicted", "rejected", "from_container_codec",
            "launches"} <= set(d)
    assert d["card"] is None and d["backend"] == "cpu" and d["frames"] == 84
    assert len(d["e2e_samples_fps"]) == 4 and len(d["classified_samples_fps"]) == 3
    assert line["value"] == max(d["e2e_samples_fps"])
    assert d["from_container_counts_equal"] is True
    assert d["from_container_codec"] == ("h264" if native_av.is_available() else "mp4v")
    # the CPU takes the kernels' plain versions, which count no launch
    assert all(v == {} for v in d["launches"].values()) and len(d["launches"]) == 6
    assert d["resident"]["resident"]["batch_windows"] == 64
    assert d["resident"]["resident_tracked"]["sums"][2] > 0

    video = scenes[1]
    jcfg = dataclasses.replace(JAX_CONFIG, batch_windows=B)
    ref = jax_run_video(JaxLooping(video.frames, total=84, fps=video.fps), video.corners, jcfg,
                        tracker_impl="device")
    assert (d["predicted"], d["rejected"], d["events"]) == (
        ref.total_predicted, ref.total_rejected, len(ref.events))
    assert d["events"] > 0


@pytest.mark.parametrize("codec", ["h264", "mp4v"])
def test_from_container_counts_equal(scenes, codec):
    """The run from an MP4 gives the counts of an ArraySource run over the
    same decoded frames, on H.264 (libav) and on mp4v (cv2's writer, the
    only MP4 codec of a host without libav); the host decode rate names
    its backend."""
    if codec == "h264" and not native_av.is_available():
        pytest.skip("no libav here: the port cannot write H.264")
    cfg, _ = _cfgs(batch_windows=B)
    fps, equal, backend, samples, got = bench_torch.e2e_from_container_fps(
        cfg, scenes[0], CPU, loops=2, samples=1, codec=codec)
    assert equal is True and got == codec and fps > 0 and len(samples) == 1
    assert backend in ("parallel", "av", "cv2")
    d_fps, label, d_codec, rates = bench_torch.host_decode_fps(scenes[0], cfg, passes=1,
                                                               codec=codec)
    assert d_codec == codec and d_fps == rates[label] > 0
    if codec == "mp4v":
        assert "cv2_gray_host" in rates and set(rates) <= {"parallel_gray_host", "cv2_gray_host"}


@pytest.mark.parametrize("main", [bench_torch.main, torch_soak.main], ids=["bench", "soak"])
def test_cuda_without_a_card_raises(main):
    """--device cuda (the default) never falls back to the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda"])


def test_watchdog_prints_an_error_line_and_exits_3():
    code = ("import time, bench_torch; bench_torch._arm_watchdog(); time.sleep(60)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "BENCH_WATCHDOG_SECS": "0.5"})
    assert proc.returncode == 3
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["value"] == 0 and line["metric"] == bench_torch.METRIC
    assert line["error"].startswith("watchdog:")


def test_soak_two_passes_scale_counts_exactly(capsys, tmp_path):
    out = tmp_path / "soak.json"
    assert torch_soak.main(["--loops", "2", "--min-passes", "2", "--height", "240", "--width",
                            "320", "--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    passes, summary = lines[:2], lines[2]
    assert [p["pass"] for p in passes] == [0, 1]
    assert all(p["counts_scale_exactly"] and p["frames"] == 126 and p["device_mem"] is None
               and p["rss_mb_after"] > 0 for p in passes)
    assert summary["counts_scale_exactly"] and summary["passes"] == 2
    assert summary["events_per_loop"] > 0 and len(summary["rss_mb_curve"]) == 2
    assert json.loads(out.read_text()) == summary
