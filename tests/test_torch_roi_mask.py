"""Port vs JAX package: ROI-mask construction (bit-equal)."""

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.geometry import crop_region_from_corners, roi_crop_region_from_corners
from swiftwatcher_tpu.io.synthetic import make_video as jax_make_video
from swiftwatcher_tpu.ops import roi_mask as jr
from swiftwatcher_tpu_torch.ops import roi_mask as tr


@pytest.mark.parametrize("shape", [(40, 55, 3), (33, 47)])
def test_median_blur(rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        tr.median_blur(torch.from_numpy(img), 9).numpy(), np.asarray(jr.median_blur(img, 9))
    )


def test_otsu(rng):
    for img in (
        rng.integers(0, 256, size=(60, 80), dtype=np.uint8),
        np.where(rng.random((50, 50)) > 0.4, 200, 30).astype(np.uint8),
    ):
        assert tr.otsu_threshold_value(img) == jr.otsu_threshold_value(img)
        np.testing.assert_array_equal(
            tr.otsu_binary(torch.from_numpy(img)).numpy(), np.asarray(jr.otsu_binary(img))
        )


@pytest.mark.parametrize("kind", ["binary", "gray"])
def test_canny(rng, kind):
    if kind == "binary":
        img = np.where(rng.random((45, 60)) > 0.7, 255, 0).astype(np.uint8)
    else:
        img = rng.integers(0, 256, size=(45, 60), dtype=np.uint8)
    for low, high in ((0, 256), (50, 150)):
        np.testing.assert_array_equal(
            tr.canny(torch.from_numpy(img), low, high).numpy(),
            np.asarray(jr.canny(img, low, high)),
        )


def test_dilate_upwards(rng):
    img = np.where(rng.random((50, 30)) > 0.95, 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(
        tr.dilate_upwards(torch.from_numpy(img), 20).numpy(),
        np.asarray(jr.dilate_upwards(img, 20)),
    )


@pytest.mark.parametrize("seed,H,W", [(0, 240, 320), (5, 360, 480)])
def test_generate_roi_mask(seed, H, W):
    video = jax_make_video(seed=seed, n_frames=3, H=H, W=W)
    frame = video.frames[0]
    crop = crop_region_from_corners(video.corners)
    roi = roi_crop_region_from_corners(video.corners)
    want = np.asarray(jr.generate_roi_mask(frame, roi, crop))
    got = tr.generate_roi_mask(frame, roi, crop, device=torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
