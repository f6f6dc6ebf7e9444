"""Port vs JAX package: the motion post-filter chain and K1's plain version;
and, on the port alone, the arguments K1's kernel design rests on (its
colour-weight table, its window-max skip, its block schedule).

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
    BLOCK,
    MARGIN,
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


def _extreme_frames(rng, shape=(2, 23, 37)):
    """Seeded frames with 0/255 extremes: noise, saturated pixels and a
    0/255 checkerboard, so |d| reaches 255 (the table's last entry)."""
    m = rng.integers(0, 256, size=shape).astype(np.uint8)
    m[rng.random(shape) < 0.2] = 0
    m[rng.random(shape) < 0.2] = 255
    yy, xx = np.indices(shape[1:])
    return np.concatenate([m, ((yy + xx) % 2 * 255).astype(np.uint8)[None]])


def _table_bilateral(frames, d=7, sigma_color=15.0, sigma_space=1.0):
    """K1's bilateral: colour weights from a 256-entry table, lut[k] =
    exp((k*k) * gc) in f32, gathered by |s - c|; taps in bilateral_offsets
    order."""
    radius, space, gc = tf.bilateral_constants(d, sigma_color, sigma_space)
    lut = torch.exp((torch.arange(256, dtype=torch.int32) ** 2).to(torch.float32) * gc)
    N, H, W = frames.shape
    iy = tf._reflect101_index(H, radius, frames.device)
    ix = tf._reflect101_index(W, radius, frames.device)
    padded = frames[:, iy][:, :, ix].to(torch.int64)
    center = frames.to(torch.int64)
    num = torch.zeros((N, H, W))
    den = torch.zeros((N, H, W))
    for (i, j, _), sw in zip(tf.bilateral_offsets(radius), space):
        sv = padded[:, radius + i : radius + i + H, radius + j : radius + j + W]
        w = sw * lut[(sv - center).abs()]
        num = num + w * sv.to(torch.float32)
        den = den + w
    return torch.round(num / den).clamp(0, 255).to(torch.uint8)


@pytest.mark.parametrize("params", [{}, TIES, dict(d=9, sigma_color=40.0), dict(sigma_color=1e7)])
def test_table_bilateral_equals_plain(rng, params):
    """(a) The colour-weight table holds the plain chain's exp values, so
    the table-driven bilateral is bit-equal to bilateral_blur."""
    m = torch.from_numpy(_extreme_frames(rng))
    assert int((m == 255).sum()) and int((m == 0).sum())
    np.testing.assert_array_equal(_table_bilateral(m, **params).numpy(),
                                  tf.bilateral_blur(m, **params).numpy())


def _window_max(frames, radius):
    """Each pixel's (2r+1)^2 window maximum on the reflect-101 pad."""
    N, H, W = frames.shape
    iy = tf._reflect101_index(H, radius, frames.device)
    ix = tf._reflect101_index(W, radius, frames.device)
    padded = frames[:, iy][:, :, ix].to(torch.float32)[:, None]
    return torch.nn.functional.max_pool2d(padded, 2 * radius + 1, stride=1)[:, 0]


@pytest.mark.parametrize("thresh", [0, 15, 40])
@pytest.mark.parametrize("params", [{}, TIES, dict(d=9, sigma_space=10.0, sigma_color=1e7)])
def test_window_max_at_or_below_threshold_gives_zero(rng, thresh, params):
    """(b) The skip's argument: the bilateral is a weighted mean, so where
    the square window's maximum is <= the threshold the plain chain's
    thresholded bilateral is 0 (planes held at exactly the threshold
    included), while pixels whose window exceeds it are computed."""
    m = (rng.random((3, 31, 45)) * (2 * thresh + 20)).astype(np.uint8)
    m[0] = thresh
    m[1, rng.random((31, 45)) < 0.9] = min(thresh, 255)
    m = torch.from_numpy(m)
    radius = max(params.get("d", 7) // 2, 1)
    quiet = _window_max(m, radius) <= thresh
    thr = tf.thresh_to_zero(tf.bilateral_blur(m, **params), thresh)
    assert bool(quiet.any()) and bool((~quiet).any())
    assert int(thr[quiet].max()) == 0
    assert int(thr[0].max()) == 0
    assert int(thr[~quiet].max()) > thresh


def _k1_schedule(m, cfg, block):
    """K1's kernel schedule on (BR, BW) blocks, emulated in torch: each
    block stages its input rows with a halo of radius + 2 and MARGIN
    columns on each side (reflect-101 within the bilateral's reach of the
    frame, 0 beyond), writes zeros if the input feeding its output is all
    at or below the threshold, else runs the table bilateral only on the
    pixels of its output +- 2 whose staged (2r+1)^2 window exceeds the
    threshold, and opens the result with the frame's edges replicated."""
    radius, space, gc = tf.bilateral_constants(
        cfg.bilateral_d, cfg.bilateral_sigma_color, cfg.bilateral_sigma_space)
    R, halo, t = radius, radius + 2, cfg.motion_threshold
    BR, BW = block
    N, H, W = m.shape
    lut = torch.exp((torch.arange(256, dtype=torch.int32) ** 2).to(torch.float32) * gc)
    out = torch.zeros_like(m)

    def staged_index(g, n):
        ok = (g >= -R) & (g < n + R)
        k = g.clamp(-R, n + R - 1).abs()
        return torch.where(k >= n, 2 * n - 2 - k, k), ok

    for n in range(N):
        for y0 in range(0, H, BR):
            for x0 in range(0, W, BW):
                iy, oky = staged_index(torch.arange(y0 - halo, y0 + BR + halo), H)
                ix, okx = staged_index(torch.arange(x0 - MARGIN, x0 + BW + MARGIN), W)
                st = torch.where(oky[:, None] & okx[None, :], m[n][iy][:, ix], 0).to(torch.int64)
                if not bool((st[:, MARGIN - halo : MARGIN + BW + halo] > t).any()):
                    continue
                wmax = torch.nn.functional.max_pool2d(st[None, None].float(), 2 * R + 1,
                                                      stride=1)[0, 0]
                TH, TW = BR + 4, BW + 4        # output +- 2, rows y0-2.., cols x0-2..
                c = st[R : R + TH, MARGIN - 2 : MARGIN - 2 + TW]
                num = torch.zeros((TH, TW))
                den = torch.zeros((TH, TW))
                for (i, j, _), sw in zip(tf.bilateral_offsets(R), space):
                    sv = st[R + i : R + i + TH, MARGIN - 2 + j : MARGIN - 2 + j + TW]
                    w = sw * lut[(sv - c).abs()]
                    num = num + w * sv.to(torch.float32)
                    den = den + w
                b = torch.round(num / den)
                hot = wmax[:TH, MARGIN - 2 - R : MARGIN - 2 - R + TW] > t
                thr = torch.where(hot & (b > t), b, 0.0).to(torch.uint8)
                # the in-frame part of the plane, opened with edge replication
                ya, yb = max(y0 - 2, 0), min(y0 + BR + 2, H)
                xa, xb = max(x0 - 2, 0), min(x0 + BW + 2, W)
                crop = thr[ya - (y0 - 2) : yb - (y0 - 2), xa - (x0 - 2) : xb - (x0 - 2)]
                ero = tf._pool2d(crop, (3, 3), "min")
                ea, eb = max(y0 - 1, 0) - ya, min(y0 + BR + 1, H) - ya
                fa, fb = max(x0 - 1, 0) - xa, min(x0 + BW + 1, W) - xa
                dil = tf._pool2d(ero[ea:eb, fa:fb], (3, 3), "max")
                ye, xe = min(y0 + BR, H), min(x0 + BW, W)
                oy, ox = y0 - max(y0 - 1, 0), x0 - max(x0 - 1, 0)
                out[n, y0:ye, x0:xe] = dil[oy : oy + ye - y0, ox : ox + xe - x0]
    return out


def _blobs(rng, shape):
    N, H, W = shape
    m = rng.integers(0, 12, size=shape).astype(np.uint8)
    for n in range(N):
        for _ in range(5):
            y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
            m[n, y : y + 4, x : x + 4] = int(rng.integers(40, 256))
    return m


@pytest.mark.parametrize("block", [BLOCK, (20, 48), (13, 32)])
@pytest.mark.parametrize("shape,overrides", [
    ((2, 47, 121), {}),
    ((2, 5, 70), {}),
    ((2, 100, 7), dict(bilateral_d=3, bilateral_sigma_color=1e7,
                       bilateral_sigma_space=math.sqrt(0.5 / math.log(2)), motion_threshold=0)),
    ((1, 40, 300), dict(bilateral_d=9, motion_threshold=30)),
    ((1, 37, 140), dict(bilateral_sigma_color=1e7, bilateral_sigma_space=10.0, motion_threshold=5)),
])
def test_k1_schedule_equals_plain(rng, block, shape, overrides):
    """(c) K1's blocks, halo, quiet-block skip and window-max skip, at its
    own block shape and at two that divide neither H nor W, give the plain
    chain bit for bit on ragged shapes, with hot pixels on block edges."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, **overrides)
    m = _blobs(rng, shape)
    H, W = shape[1:]
    for c in range(0, W, block[1]):
        m[0, : H : 7, max(c - 1, 0)] = 255
    m = torch.from_numpy(m)
    want = fused_motion_filter_reference(m, cfg)
    assert int((want > 0).sum()) > 0
    np.testing.assert_array_equal(_k1_schedule(m, cfg, block).numpy(), want.numpy())
