"""Port vs JAX package: the motion post-filter chain and K1's plain version.

Tolerance: bit-equal.  Torch's and XLA's CPU exp may differ in the last
bit of a weight; on these inputs that moves no uint8 output (a rounding tie
would be bounded by PARITY deviation 9's envelope, <= +-1 on < 1% of
pixels, which these tests do not need)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG
from swiftwatcher_tpu.ops import filtering as jf
from swiftwatcher_tpu.ops.pallas.fused_motion import fused_motion_filter as jax_fused
from swiftwatcher_tpu_torch.ops import filtering as tf
from swiftwatcher_tpu_torch.ops.fused_motion import (
    fused_motion_filter,
    fused_motion_filter_reference,
)


def _realistic_motion(rng, N=3, H=48, W=64):
    m = np.zeros((N, H, W), np.uint8)
    for n in range(N):
        for _ in range(3):
            y, x = rng.integers(2, H - 6), rng.integers(2, W - 6)
            m[n, y : y + 4, x : x + 4] = rng.integers(60, 200)
    noise = rng.integers(0, 10, size=m.shape, dtype=np.uint8)
    return np.maximum(m, noise)


def _chunk_boundary_cases(rng):
    """The 36-row early-out cases of tests/test_pallas_fused.py."""
    H, W = 144, 64
    cases = [
        np.zeros((1, H, W), np.uint8),
        np.full((1, H, W), 15, np.uint8),
        np.full((1, H, W), 16, np.uint8),
    ]
    for r in (0, 33, 34, 35, 36, 37, 38, 71, 72, 107, 108, 143):
        m = (rng.random((1, H, W)) * 10).astype(np.uint8)
        m[0, r, 20] = 120
        cases.append(m)
    return np.concatenate(cases)


# Space weights of exactly 1 and 0.5 (exp(-ln 2)) and colour weights of 1:
# a 3x3 cross then averages to exact .5 ties, which round half to even.
TIES = dict(d=3, sigma_color=1e7, sigma_space=math.sqrt(0.5 / math.log(2)))


@pytest.mark.parametrize("params,top", [({}, 256), (TIES, 4)])
def test_bilateral_bit_equal(rng, params, top):
    m = rng.integers(0, top, size=(2, 19, 27), dtype=np.uint8)
    want = np.asarray(jf.bilateral_blur(m, **params))
    np.testing.assert_array_equal(
        tf.bilateral_blur(torch.from_numpy(m), **params).numpy(), want
    )


@pytest.mark.parametrize("size", [(3, 3), (2, 4), (5, 1)])
def test_opening_bit_equal(rng, size):
    m = rng.integers(0, 256, size=(2, 13, 17), dtype=np.uint8)
    want = np.asarray(jf.grayscale_opening(m, size))
    got = tf.grayscale_opening(torch.from_numpy(m), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_thresh_to_zero_bit_equal():
    m = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jf.thresh_to_zero(m, 15))
    np.testing.assert_array_equal(tf.thresh_to_zero(torch.from_numpy(m), 15).numpy(), want)


def test_motion_postfilter_bit_equal(rng):
    m = _realistic_motion(rng)
    want = np.asarray(jf.motion_postfilter(m, DEFAULT_CONFIG))
    got = tf.motion_postfilter(torch.from_numpy(m), DEFAULT_CONFIG).numpy()
    np.testing.assert_array_equal(got, want)


def test_k1_plain_vs_pallas_interpret(rng):
    m = _realistic_motion(rng)
    want = np.asarray(jax_fused(m, DEFAULT_CONFIG, interpret=True))
    np.testing.assert_array_equal(
        fused_motion_filter_reference(torch.from_numpy(m), DEFAULT_CONFIG).numpy(), want
    )


def test_k1_plain_chunk_boundaries_vs_pallas_interpret(rng):
    m = _chunk_boundary_cases(rng)
    want = np.asarray(jax_fused(m, DEFAULT_CONFIG, interpret=True))
    got = fused_motion_filter_reference(torch.from_numpy(m), DEFAULT_CONFIG).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jf.motion_postfilter(m, DEFAULT_CONFIG)))


def test_k1_wrapper_takes_plain_version_on_cpu(rng):
    m = torch.from_numpy(_realistic_motion(rng))
    before = fused_motion_filter.launches
    got = fused_motion_filter(m, DEFAULT_CONFIG)
    assert fused_motion_filter.launches == before   # no kernel launched
    np.testing.assert_array_equal(
        got.numpy(), fused_motion_filter_reference(m, DEFAULT_CONFIG).numpy()
    )


def test_k1_wrapper_refuses_other_devices_and_openings():
    with pytest.raises(ValueError):
        fused_motion_filter(torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta"))
    cfg = dataclasses.replace(DEFAULT_CONFIG, opening_size=(5, 5))
    with pytest.raises(ValueError):
        fused_motion_filter(torch.zeros((1, 8, 8), dtype=torch.uint8), cfg)


@pytest.mark.parametrize("opening", [(3, 3), (5, 5)])
def test_apply_postfilter_gate_on_cpu(rng, opening):
    cfg = dataclasses.replace(DEFAULT_CONFIG, opening_size=opening)
    m = _realistic_motion(rng, N=2)
    want = np.asarray(jf.apply_postfilter(m, cfg))
    np.testing.assert_array_equal(tf.apply_postfilter(torch.from_numpy(m), cfg).numpy(), want)
