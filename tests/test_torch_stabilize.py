"""The port's stabilisation (swiftwatcher_tpu_torch/ops/stabilize.py) vs the
JAX package's (swiftwatcher_tpu/ops/stabilize.py), bit for bit: for J = 0
to 4, on windows shaken by planted integer shifts (with the ROI frame's
pose as the reference and without one), on batched windows, and on a
window whose candidates tie exactly (both pick the lowest candidate
index).  Then localize_windows_gray with stabilisation on, against the
JAX package's, on a jittered scene."""

import dataclasses

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.ops.stabilize import stabilize_window as jax_stabilize
from swiftwatcher_tpu.pipeline.window import localize_windows_gray as jax_localize
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.ops.stabilize import stabilize_window
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray


def _shaken(rng, offsets, H=48, W=64, J=4):
    """Frame t = a blocky world seen at camera offset offsets[t]."""
    Hw, Ww = H + 2 * J, W + 2 * J
    coarse = rng.integers(0, 256, size=(Hw // 8 + 1, Ww // 8 + 1))
    world = np.kron(coarse, np.ones((8, 8), np.int64))[:Hw, :Ww].astype(np.uint8)
    frames = np.stack([world[J + dy : J + dy + H, J + dx : J + dx + W] for dy, dx in offsets])
    return world[J : J + H, J : J + W], frames


def _both(gray, J, ref=None):
    ours = stabilize_window(torch.from_numpy(gray), J,
                            None if ref is None else torch.from_numpy(ref))
    theirs = jax_stabilize(gray, J, ref)
    return [t.numpy() for t in ours], [np.asarray(t) for t in theirs]


@pytest.mark.parametrize("J", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("with_ref", [True, False])
def test_planted_shifts_vs_jax(J, with_ref):
    rng = np.random.default_rng(J)
    offsets = [(0, 0)] + [tuple(int(v) for v in rng.integers(-J, J + 1, 2)) for _ in range(8)]
    pose, frames = _shaken(rng, offsets)
    (aligned, shifts), (j_aligned, j_shifts) = _both(frames, J, pose if with_ref else None)
    np.testing.assert_array_equal(aligned, j_aligned)
    np.testing.assert_array_equal(shifts, j_shifts)
    assert aligned.dtype == np.uint8 and shifts.dtype == np.int32
    assert shifts.shape == (len(offsets), 2)
    if with_ref and J > 0:
        # against the reference pose, each chosen shift cancels its offset
        np.testing.assert_array_equal(shifts, -np.array(offsets))
    if J == 0:
        np.testing.assert_array_equal(aligned, frames)
        assert not shifts.any()


@pytest.mark.parametrize("J", [1, 3])
def test_batched_windows_vs_jax(J):
    rng = np.random.default_rng(10 + J)
    windows = []
    for _ in range(3):
        offsets = [tuple(int(v) for v in rng.integers(-J, J + 1, 2)) for _ in range(5)]
        windows.append(_shaken(rng, offsets, H=40, W=56, J=J)[1])
    gray = np.stack(windows)                # (B, T, H, W)
    ref = rng.integers(0, 256, size=(40, 56)).astype(np.int32)
    for r in (None, ref):
        (aligned, shifts), (j_aligned, j_shifts) = _both(gray, J, r)
        np.testing.assert_array_equal(aligned, j_aligned)
        np.testing.assert_array_equal(shifts, j_shifts)
        assert shifts.shape == (3, 5, 2)


@pytest.mark.parametrize("J", [1, 2, 3])
def test_a_tie_goes_to_the_lowest_candidate(J):
    """A flat frame scores the same SAD at every shift: all (2J+1)^2
    candidates tie, and both pick candidate 0, the shift (-J, -J).  A
    frame with one bright column ties between the row shifts only."""
    flat = np.full((2, 16, 24), 90, np.uint8)
    col = np.full((1, 16, 24), 90, np.uint8)
    col[0, :, 12] = 200
    ref = col[0].copy()
    for frames, r in ((flat, None), (col, ref)):
        (aligned, shifts), (j_aligned, j_shifts) = _both(frames, J, r)
        np.testing.assert_array_equal(shifts, j_shifts)
        np.testing.assert_array_equal(aligned, j_aligned)
        assert (shifts[:, 0] == -J).all()
    assert (shifts[:, 1] == 0).all()        # the column's own pose wins its row


def test_localize_with_stabilisation_vs_jax():
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video

    video = make_hard_video(seed=49, n_entering=3, jitter=2, n_frames=21, H=240, W=320)
    from swiftwatcher_tpu_torch.geometry import crop_array, crop_region_from_corners
    from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host

    crop = crop_region_from_corners(video.corners, DEFAULT_CONFIG)
    gray = bgr_to_gray_host(np.stack([crop_array(f, crop) for f in video.frames]))[None]
    ref = bgr_to_gray_host(crop_array(video.frames[0], crop))
    cfg = dataclasses.replace(DEFAULT_CONFIG, stabilize_max_shift=3)
    jcfg = dataclasses.replace(JAX_CONFIG, stabilize_max_shift=3)
    table, iters = localize_windows_gray(torch.from_numpy(gray), cfg,
                                         stab_ref=torch.from_numpy(ref))
    j_table, j_iters = jax_localize(gray, jcfg, stab_ref=ref)
    valid = table.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(j_table.valid))
    assert valid.any()
    for name in ("area", "sum_y", "sum_x"):
        np.testing.assert_array_equal(getattr(table, name).numpy()[valid],
                                      np.asarray(getattr(j_table, name))[valid])
