"""The port's single-window API against the JAX package's, on the CPU:
ialm_rpca with its two SVD methods ("device", the row-space SVD, and
"host_svd", the LAPACK oracle), rpca_motion_window, localize_window and
localize_window_debug (each named stage), and tools/torch_dump_stages.py.

Tolerances:
  * ialm_rpca in f64 (JAX under x64): iteration counts equal, A and E
    within IALM_F64_ATOL of the JAX package's with the same method, and of
    each other (device vs host_svd: chip_smoke.py holds the card to the
    same bound);
  * in f32 the motion clip(-E) stays inside the +-1-u8 envelope of
    tests/test_torch_rpca.py (iterations within 1, |diff| <= 3, >= 99.9% of
    pixels within 1): XLA on the CPU fuses multiply-adds and sums in
    another order;
  * u8 planes after RPCA (each stage applied to the same RPCA plane),
    labels and tables are bit-equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.ops import ccl as jax_ccl
from swiftwatcher_tpu.ops import filtering as jax_filtering
from swiftwatcher_tpu.ops import props as jax_props
from swiftwatcher_tpu.ops import rpca as jax_rpca
from swiftwatcher_tpu.pipeline import window as jax_window
from swiftwatcher_tpu_torch import ui
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.geometry import crop_array, crop_region_from_corners
from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter_reference
from swiftwatcher_tpu_torch.ops.rpca import (
    ialm_rpca,
    rpca_motion_window,
    rpca_motion_window_batched,
)
from swiftwatcher_tpu_torch.io.synthetic import make_hard_video, make_video
from swiftwatcher_tpu_torch.pipeline.window import localize_window, localize_window_debug

from oracles import make_synthetic_window

ROOT = Path(__file__).resolve().parent.parent
IALM_F64_ATOL = 1e-6
TABLE_FIELDS = ("valid", "area", "sum_y", "sum_x", "min_y", "min_x", "max_y", "max_x")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _window(seed, H=24, W=32):
    win = make_synthetic_window(np.random.default_rng(seed), T=21, H=H, W=W)
    return win.reshape(21, -1).T


def _jax_ialm(X, method):
    with jax.enable_x64(X.dtype == np.float64):
        return tuple(np.asarray(a) for a in jax_rpca.ialm_rpca(X, method=method))


def _within_envelope(m, jm, it, jit):
    diff = np.abs(m.astype(int) - jm.astype(int))
    assert abs(int(it) - int(jit)) <= 1
    assert diff.max() <= 3 and (diff <= 1).mean() >= 0.999


@pytest.mark.parametrize("method", ["device", "host_svd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ialm_rpca_f64_vs_jax(method, seed):
    X = _window(seed).astype(np.float64)
    A, E, it = ialm_rpca(torch.from_numpy(X), method=method)
    jA, jE, jit = _jax_ialm(X, method)
    assert it == int(jit) and it > 5
    np.testing.assert_allclose(A.numpy(), jA, rtol=0, atol=IALM_F64_ATOL)
    np.testing.assert_allclose(E.numpy(), jE, rtol=0, atol=IALM_F64_ATOL)


def test_ialm_rpca_device_vs_host_svd_f64():
    """The device solver against the oracle, the check chip_smoke.py makes
    on the card at the main path's 216 x 432 window.  The windows hold u8
    values, so 1e-6 sits far below the f32 solvers' gap of about 1 and
    above the rounding of the two f64 solvers on small crops, which run
    more iterations than the bench window."""
    X = torch.from_numpy(_window(2, H=48, W=64).astype(np.float64))
    A, E, it = ialm_rpca(X, method="device")
    hA, hE, hit = ialm_rpca(X, method="host_svd")
    assert it == hit
    assert float((A - hA).abs().max()) <= IALM_F64_ATOL
    assert float((E - hE).abs().max()) <= IALM_F64_ATOL


@pytest.mark.parametrize("method", ["device", "host_svd"])
def test_ialm_rpca_f32_vs_jax_within_envelope(method):
    X = _window(3).astype(np.float32)
    A, E, it = ialm_rpca(torch.from_numpy(X), method=method)
    assert A.dtype == E.dtype == torch.float32
    jA, jE, jit = _jax_ialm(X, method)
    motion = np.clip(-E.numpy(), 0, 255).astype(np.uint8)
    _within_envelope(motion, np.clip(-jE, 0, 255).astype(np.uint8), it, jit)
    assert (motion > 50).any()


def test_ialm_rpca_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        ialm_rpca(torch.zeros(4, 3), method="svd")


def test_rpca_motion_window_is_the_batched_solver():
    gray = make_synthetic_window(np.random.default_rng(4), T=21, H=24, W=32)
    m, it = rpca_motion_window(torch.from_numpy(gray), DEFAULT_CONFIG)
    bm, bit = rpca_motion_window_batched(torch.from_numpy(gray)[None], DEFAULT_CONFIG)
    assert m.shape == (21, 24, 32) and it.shape == ()
    np.testing.assert_array_equal(m.numpy(), bm[0].numpy())
    assert int(it) == int(bit[0])
    jm, jit = jax_rpca.rpca_motion_window(gray, JAX_CONFIG)
    _within_envelope(m.numpy(), np.asarray(jm), it, jit)


def _crop(video, window, cfg=DEFAULT_CONFIG):
    region = crop_region_from_corners(video.corners, cfg)
    T = cfg.window_size
    return np.stack([crop_array(f, region) for f in video.frames[window * T:(window + 1) * T]])


@pytest.mark.parametrize("case", ["small-w0", "small-w1", "jitter2-stabilised"])
def test_localize_window_bit_equal_to_jax(case):
    if case == "jitter2-stabilised":
        video = make_hard_video(seed=49, n_entering=3, jitter=2, n_frames=21)
        crop, shift = _crop(video, 0), 3
    else:
        video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
        crop, shift = _crop(video, int(case[-1])), 0
    cfg = dataclasses.replace(DEFAULT_CONFIG, stabilize_max_shift=shift)
    jcfg = dataclasses.replace(JAX_CONFIG, stabilize_max_shift=shift)
    table, labels, it = localize_window(torch.from_numpy(crop), cfg)
    jtable, jlabels, jit = jax_window.localize_window(crop, jcfg)
    assert int(it) == int(jit)
    assert labels.dtype == torch.uint8 and table.valid.shape == (21, 256)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(table, f).numpy(), np.asarray(getattr(jtable, f)),
                                      err_msg=f)
    assert table.valid.any()


def test_localize_window_debug_stages():
    video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
    crop = _crop(video, 0)
    cfg = DEFAULT_CONFIG
    table, stages, it = localize_window_debug(torch.from_numpy(crop), cfg)
    jtable, jstages, jit = jax_window.localize_window_debug(crop, JAX_CONFIG)
    # the reference's order (a jitted dict of the JAX package comes back sorted)
    assert list(stages) == ["grayscale", "RPCA", "bilateral", "thresh_15", "opened",
                            "cc_labeling"]
    assert set(jstages) == set(stages)
    planes = {k: v.numpy() for k, v in stages.items()}
    assert all(p.dtype == np.uint8 and p.shape == crop.shape[:3] for p in planes.values())
    np.testing.assert_array_equal(planes["grayscale"], np.asarray(jstages["grayscale"]))
    _within_envelope(planes["RPCA"], np.asarray(jstages["RPCA"]), it, jit)
    # each later stage: the JAX stage function of the port's previous plane
    bil = jax_filtering.bilateral_blur(planes["RPCA"], cfg.bilateral_d, cfg.bilateral_sigma_color,
                                       cfg.bilateral_sigma_space)
    np.testing.assert_array_equal(planes["bilateral"], np.asarray(bil))
    thr = jax_filtering.thresh_to_zero(planes["bilateral"], cfg.motion_threshold)
    np.testing.assert_array_equal(planes["thresh_15"], np.asarray(thr))
    opened = jax_filtering.grayscale_opening(planes["thresh_15"], tuple(cfg.opening_size))
    np.testing.assert_array_equal(planes["opened"], np.asarray(opened))
    labels, _ = jax_ccl.label_components(planes["opened"] > 0, cfg.ccl_max_iters)
    labels_u8 = np.asarray(jax_ccl.wrap_labels_uint8(labels, cfg.label_modulus))
    np.testing.assert_array_equal(planes["cc_labeling"], labels_u8)
    jt = jax_props.region_tables(labels_u8)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(table, f).numpy(), np.asarray(getattr(jt, f)))
    # the stage-by-stage opening is K1's plain version on the same plane
    np.testing.assert_array_equal(
        planes["opened"], fused_motion_filter_reference(stages["RPCA"], cfg).numpy())
    assert planes["opened"].any() and planes["cc_labeling"].any()


def test_dump_stages_tool(tmp_path):
    import cv2

    video = make_video(seed=0, n_frames=42, n_entering=2)
    clip = tmp_path / "clip.npy"
    np.save(clip, video.frames)
    ui.save_corners_to_file(clip, video.corners)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_dump_stages.py"), str(clip), "--window",
         "1", "--device", "cpu"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "clip" / "stages"
    assert "wrote 6 stages x 21 frames" in proc.stdout
    assert len(list(out.glob("*.png"))) == 6 * 21
    _, stages, _ = localize_window_debug(torch.from_numpy(_crop(video, 1)), DEFAULT_CONFIG)
    for name in ("grayscale", "opened"):
        got = cv2.imread(str(out / f"30_{name}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, stages[name][9].numpy())
