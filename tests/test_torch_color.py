"""Port vs JAX package: BGR -> gray (bit-equal)."""

import numpy as np
import torch

from swiftwatcher_tpu.ops.color import bgr_to_gray as jax_bgr_to_gray
from swiftwatcher_tpu.ops.color import bgr_to_gray_host as jax_bgr_to_gray_host
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray, bgr_to_gray_host


def _frames(rng):
    x = rng.integers(0, 256, size=(3, 17, 23, 3), dtype=np.uint8)
    x[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    return x


def test_bgr_to_gray_bit_equal(rng):
    x = _frames(rng)
    want = np.asarray(jax_bgr_to_gray(x))
    np.testing.assert_array_equal(bgr_to_gray(torch.from_numpy(x)).numpy(), want)


def test_bgr_to_gray_host_bit_equal(rng):
    x = _frames(rng)
    want = jax_bgr_to_gray_host(x)
    np.testing.assert_array_equal(bgr_to_gray_host(x), want)
    np.testing.assert_array_equal(bgr_to_gray_host(x[0]), want[0])


def test_bgr_to_gray_exhaustive_channel_ramps():
    # every value on each channel alone and on all three together
    v = np.arange(256, dtype=np.uint8)
    x = np.zeros((4, 256, 3), np.uint8)
    for c in range(3):
        x[c, :, c] = v
    x[3] = v[:, None]
    want = np.asarray(jax_bgr_to_gray(x))
    np.testing.assert_array_equal(bgr_to_gray(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(bgr_to_gray_host(x), want)
