"""The port's classifier preprocessing and filter
(swiftwatcher_tpu_torch/models/{preprocess,classifier}.py) vs the JAX
package's and PIL on the CPU.

The resample is held byte for byte: the 24x24 uint8 image recovered from
preprocess_batch equals PIL's and the JAX package's on the 100 sizes of
tests/test_classifier_device.py.  The normalized tensor is bit-equal to
the port's own PIL path (preprocess_segment: PIL, then numpy's IEEE f32
divide) and within 2e-6 of the JAX package's, the tolerance its own test
gives the same comparison: XLA rewrites a division by a constant as a
product with its reciprocal and distributes it, so its f32 results differ
from IEEE division by an ulp or two.  Keep-masks equal the JAX filter's
with three weight sets, on the device path, the PIL path (oversized crops,
cnn_device_preprocess=False) and either canvas bucket; batch_call equals
__call__, degenerate crops included."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.models import classifier as jax_classifier
from swiftwatcher_tpu.models import preprocess as jax_preprocess
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.models import classifier, preprocess
from swiftwatcher_tpu_torch.models.squeezenet import params_from_jax
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")
SIZES = [(h, w) for h in (1, 3, 5, 13, 24, 25, 26, 33, 47, 64)
         for w in (1, 3, 5, 13, 24, 25, 26, 33, 47, 64)]
# classifier.1.bias[1] of each weight set (the shipped value is -0.0086)
BIASES = {"shipped": None, "split": -200.0, "partial": -150.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(name):
    with np.load(jax_classifier.DEFAULT_WEIGHTS) as data:
        params = {k: data[k].copy() for k in data.files}
    if BIASES[name] is not None:
        params["classifier.1.bias"][1] = BIASES[name]
    return params


@pytest.fixture(scope="module")
def filters():
    """{weights: (port filter, JAX filter)}."""
    return {name: (classifier.SqueezeNetSegmentFilter(params_from_jax(_weights(name)),
                                                      DEFAULT_CONFIG, CPU),
                   jax_classifier.SqueezeNetSegmentFilter(_weights(name), JAX_CONFIG))
            for name in BIASES}


def _u8_of(full, cfg):
    """The 24x24 uint8 resample inside an (N, 224, 224, 3) normalized batch."""
    mean = np.asarray(cfg.cnn_mean, np.float32)
    std = np.asarray(cfg.cnn_std, np.float32)
    pad = (cfg.cnn_input_size - cfg.cnn_resize_to) // 2
    sl = slice(pad, pad + cfg.cnn_resize_to)
    return np.round((full[:, sl, sl] * std + mean) * 255.0).astype(np.uint8)


def _ours(canv, hs, ws, mx, cfg=DEFAULT_CONFIG):
    out = preprocess.preprocess_batch(
        torch.from_numpy(canv),
        torch.from_numpy(preprocess.resize_coeffs(ws, mx, cfg.cnn_resize_to)),
        torch.from_numpy(preprocess.resize_coeffs(hs, mx, cfg.cnn_resize_to)), cfg)
    assert out.shape == (len(canv), 3, cfg.cnn_input_size, cfg.cnn_input_size)
    return out.permute(0, 2, 3, 1).numpy()


def test_preprocess_batch_vs_pil_and_jax(rng):
    cfg = DEFAULT_CONFIG
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in SIZES]
    canv, hs, ws = preprocess.pack_canvases(imgs, 64)
    ours = _ours(canv, hs, ws, 64)
    theirs = np.asarray(jax_preprocess.preprocess_batch(
        jnp.asarray(canv), jnp.asarray(jax_preprocess.resize_coeffs(ws, 64, 24)),
        jnp.asarray(jax_preprocess.resize_coeffs(hs, 64, 24)), JAX_CONFIG))
    pil = np.stack([np.asarray(Image.fromarray(im).resize((24, 24), Image.BILINEAR))
                    for im in imgs])
    np.testing.assert_array_equal(_u8_of(ours, cfg), pil)
    np.testing.assert_array_equal(_u8_of(ours, cfg), _u8_of(theirs, cfg))
    np.testing.assert_array_equal(ours, np.stack(
        [classifier.preprocess_segment(im, cfg) for im in imgs]))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6)
    # the padding ring is the normalized zero
    np.testing.assert_array_equal(
        ours[:, 0, 0], np.broadcast_to(classifier.preprocess_segment(
            np.zeros((1, 1, 3), np.uint8), cfg)[0, 0], (len(imgs), 3)))


def test_canvas_size_changes_nothing(rng):
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in SIZES if max(h, w) <= 32]
    a = _ours(*preprocess.pack_canvases(imgs, 32), 32)
    b = _ours(*preprocess.pack_canvases(imgs, 64), 64)
    np.testing.assert_array_equal(a, b)


def _crops(rng, n, most=64):
    """Crops of a bright dot on a noisy sky, the shape of a segment."""
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(24, most + 1, 2))
        im = rng.normal(120, 12, (h, w, 3)).clip(0, 255).astype(np.uint8)
        cy, cx, r = rng.integers(4, h - 4), rng.integers(4, w - 4), rng.integers(2, 6)
        im[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = rng.integers(0, 60)
        out.append(im)
    return out


@pytest.fixture(scope="module")
def scene_crops(filters):
    """The 15 segment crops of tests/test_torch_classify_runner.py's small
    scene (every one kept by the shipped weights, about half by "split"),
    then 37 synthetic ones (a dark square on noise: all rejected)."""
    seen = []

    class Recording(classifier.SqueezeNetSegmentFilter):
        def classify_images(self, images, timers=None):
            seen.extend(images)
            return super().classify_images(images, timers)

    video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1)
    run_video(ArraySource(video.frames, fps=video.fps), video.corners, DEFAULT_CONFIG, CPU,
              segment_filter=Recording(filters["shipped"][0].params, DEFAULT_CONFIG, CPU))
    assert len(seen) == 15
    return seen + _crops(np.random.default_rng(5), 37)


@pytest.mark.parametrize("weights", sorted(BIASES))
def test_classify_images_vs_jax(filters, scene_crops, weights):
    ours_f, theirs_f = filters[weights]
    ours = ours_f.classify_images(scene_crops)
    theirs = np.asarray(theirs_f.classify_images(scene_crops))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == bool and ours.shape == (52,)
    # the masks keep and reject
    assert ours[:15].any() and not ours[15:].any()
    if weights == "split":
        assert 0 < ours[:15].sum() < 15


def test_oversized_crops_take_pil_vs_jax(filters, scene_crops):
    rng = np.random.default_rng(6)
    crops = scene_crops[:15] + _crops(rng, 5) + [
        rng.integers(0, 256, (70, 30, 3), np.uint8), rng.integers(0, 256, (100, 100, 3), np.uint8)]
    for weights in sorted(BIASES):
        ours_f, theirs_f = filters[weights]
        assert ours_f._canvas_bucket(crops) == 0
        timers = {}
        ours = ours_f.classify_images(crops, timers=timers)
        np.testing.assert_array_equal(ours, np.asarray(theirs_f.classify_images(crops)))
        assert set(timers) == {"classify_pack", "classify_device"}


def test_host_pil_path_equals_device_path(filters, scene_crops):
    ours_f = filters["split"][0]
    crops = scene_crops[:15] + _crops(np.random.default_rng(8), 20)
    host = classifier.SqueezeNetSegmentFilter(
        ours_f.params, dataclasses.replace(DEFAULT_CONFIG, cnn_device_preprocess=False), CPU)
    np.testing.assert_array_equal(host.classify_images(crops), ours_f.classify_images(crops))


def test_canvas_bucket_and_padding_vs_jax(filters, scene_crops, monkeypatch):
    ours_f, theirs_f = filters["split"]
    rng = np.random.default_rng(9)
    small = [c for c in scene_crops[:15] if max(c.shape[:2]) <= 32] + _crops(rng, 6, most=32)
    assert ours_f._canvas_bucket(small) == theirs_f._canvas_bucket(small) == 32
    big = small + _crops(rng, 1, most=64)
    assert ours_f._canvas_bucket(big) == theirs_f._canvas_bucket(big)
    for cap in (64, 48, 5):
        ours_f.cfg = dataclasses.replace(DEFAULT_CONFIG, cnn_batch_cap=cap)
        theirs_f.cfg = dataclasses.replace(JAX_CONFIG, cnn_batch_cap=cap)
        try:
            for n in range(1, 140):
                assert ours_f._padded_n(n) == theirs_f._padded_n(n)
        finally:
            ours_f.cfg, theirs_f.cfg = DEFAULT_CONFIG, JAX_CONFIG
    want = ours_f.classify_images(small)
    monkeypatch.setattr(classifier.SqueezeNetSegmentFilter, "_canvas_bucket",
                        lambda self, images: 64)
    np.testing.assert_array_equal(ours_f.classify_images(small), want)


class Table:
    """A host RegionTable stand-in: (B, T, 256) planes."""

    def __init__(self, rng, B, T, H, W, frame_hw):
        shape = (B, T, 256)
        self.valid = np.zeros(shape, bool)
        self.min_y, self.min_x, self.max_y, self.max_x = (np.zeros(shape, np.int32)
                                                          for _ in range(4))
        for b in range(B):
            for t in range(T):
                ks = rng.choice(np.arange(1, 256), rng.integers(0, 5), replace=False)
                for k in ks:
                    y, x = rng.integers(0, H - 2), rng.integers(0, W - 2)
                    self.valid[b, t, k] = True
                    self.min_y[b, t, k], self.min_x[b, t, k] = y, x
                    self.max_y[b, t, k] = y + rng.integers(1, min(40, H - y) + 1)
                    self.max_x[b, t, k] = x + rng.integers(1, min(40, W - x) + 1)
        # one degenerate crop: its expanded bbox lies past the frame's edge
        self.valid[0, 0, 200] = True
        self.min_y[0, 0, 200], self.max_y[0, 0, 200] = frame_hw[0] + 50, frame_hw[0] + 60
        self.min_x[0, 0, 200], self.max_x[0, 0, 200] = 5, 10


@pytest.mark.parametrize("weights", ["split", "partial"])
def test_batch_call_equals_per_frame_and_jax(filters, weights):
    ours_f, theirs_f = filters[weights]
    rng = np.random.default_rng(11)
    crop_region = ((40, 30), (40 + 160, 30 + 120))
    B, T = 2, 3
    table = Table(rng, B, T, 120, 160, (180, 240))
    frames = {(b, t): rng.normal(120, 20, (180, 240, 3)).clip(0, 255).astype(np.uint8)
              for b in range(B) for t in range(T) if table.valid[b, t].any()}
    timers = {}
    ours = ours_f.batch_call(table, frames, crop_region, timers=timers)
    assert set(timers) == {"classify_crop", "classify_pack", "classify_device"}
    assert ours == theirs_f.batch_call(table, frames, crop_region)
    for key, frame in frames.items():
        assert ours[key] == ours_f(table, key, frame, crop_region)
        assert len(ours[key]) == int(table.valid[key].sum())
    assert ours[0, 0][-1] is False      # the degenerate crop is dropped


def test_missing_weights_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(classifier, "DEFAULT_WEIGHTS", tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        classifier.SqueezeNetSegmentFilter.from_default_weights(DEFAULT_CONFIG, CPU)
