"""Segment classifier: the SqueezeNet filter over a batch's segment tables.

Counterpart of swiftwatcher_tpu/models/classifier.py, after the reference's
SegmentClassifier (segment_classification.py:14-44): each segment's bbox
is expanded to at least 24x24 (centered, floor/ceil split), the crop is
taken from the FULL-resolution BGR frame offset by the crop region's
origin, resized to 24x24 (PIL bilinear), zero-padded to 224x224, scaled to
[0, 1] and ImageNet-normalized, with the reference's channel quirk kept:
the BGR array goes to the RGB-stat normalizer untouched.  keep = argmax == 1.

All of a batch's crops go through one forward on the filter's device.  The
host packs the crops into zero-padded canvases; the PIL-exact resize
(models/preprocess.py), the normalization and the network run on the
device.  A crop larger than every canvas (cnn_max_seg_hw), or
cnn_device_preprocess=False, takes PIL on the host instead, and its
output still goes to the device for the forward.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..device import pin_numerics
from .preprocess import pack_canvases, preprocess_batch, resize_coeffs
from .squeezenet import params_from_jax, predict

DEFAULT_WEIGHTS = Path(__file__).parent / "segment_classifier.npz"


def _add_seconds(timers, key: str, seconds: float) -> None:
    if timers is not None:
        timers[key] = timers.get(key, 0.0) + seconds


def upload(arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """Host arrays -> device tensors in ONE copy: the arrays' bytes are laid
    end to end in one buffer (pinned for a card, so the copy does not make
    the host wait for the stream) and viewed back on the device.  Each
    array's byte size must keep the next one aligned to its itemsize."""
    sizes = [a.nbytes for a in arrays]
    pin = device.type == "cuda"
    host = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=pin)
    view = host.numpy()
    out, at = [], 0
    for a, n in zip(arrays, sizes):
        view[at:at + n] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        at += n
    dev = host.to(device, non_blocking=pin)
    at = 0
    for a, n in zip(arrays, sizes):
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
        out.append(dev[at:at + n].view(dtype).view(a.shape))
        at += n
    return out


def classify_canvases(params, canv, coeff_table, hs, ws, cfg: PipelineConfig):
    """Per-size coefficient gather -> PIL-exact resize -> pad/normalize ->
    SqueezeNet -> argmax labels, all on canv's device.

    coeff_table is the device-resident (mx, out, mx) table of PIL tap
    weights for every extent 1..mx; row s-1 is resize_coeffs([s], mx, out)."""
    batch = preprocess_batch(canv, coeff_table[ws - 1], coeff_table[hs - 1], cfg)
    return predict(params, batch)


def expand_bbox(bbox: Sequence[int], min_size: Sequence[int]) -> List[int]:
    """Expand [y1, x1, y2, x2] to at least min_size, centered
    (image_filtering.py:350-358)."""
    y1, x1, y2, x2 = (int(v) for v in bbox)
    h, w = y2 - y1, x2 - x1
    if h < min_size[0]:
        diff = min_size[0] - h
        y1 -= math.floor(diff / 2)
        y2 += math.ceil(diff / 2)
    if w < min_size[1]:
        diff = min_size[1] - w
        x1 -= math.floor(diff / 2)
        x2 += math.ceil(diff / 2)
    return [y1, x1, y2, x2]


def extract_segment_image(frame_bgr: np.ndarray, bbox, crop_region, min_size) -> np.ndarray:
    """Slice the expanded bbox from the full-resolution frame
    (image_filtering.py:360-365; offsets are the crop region's origin)."""
    y1, x1, y2, x2 = expand_bbox(bbox, min_size)
    oy, ox = crop_region[0][1], crop_region[0][0]
    return frame_bgr[y1 + oy : y2 + oy, x1 + ox : x2 + ox]


def preprocess_segment(img_bgr: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Segment crop -> (224, 224, 3) float32 normalized by PIL on the host,
    the reference's own transform stack (segment_classification.py:18-24)."""
    from PIL import Image

    im = Image.fromarray(img_bgr)  # BGR bytes read as RGB, as the reference does
    im = im.resize((cfg.cnn_resize_to, cfg.cnn_resize_to), Image.BILINEAR)
    small = np.asarray(im, np.float32) / 255.0
    pad = (cfg.cnn_input_size - cfg.cnn_resize_to) // 2
    full = np.zeros((cfg.cnn_input_size, cfg.cnn_input_size, 3), np.float32)
    full[pad : pad + cfg.cnn_resize_to, pad : pad + cfg.cnn_resize_to] = small
    mean = np.asarray(cfg.cnn_mean, np.float32)
    std = np.asarray(cfg.cnn_std, np.float32)
    return (full - mean) / std


class SqueezeNetSegmentFilter:
    """segment_filter hook of pipeline.runner.run_video, on one device."""

    # the device tracker may run this filter's forward in the same queued
    # sequence as its tracking scan (pipeline/classify_fused.py); filters
    # without the attribute take the unfused path
    supports_fused = True

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: PipelineConfig,
                 device: torch.device):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            pin_numerics()
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.cfg = cfg
        self.upload_bytes = 0  # host -> device canvas, size and table bytes
        self._coeff_tables: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_weights(cls, path, cfg: PipelineConfig, device: torch.device):
        """From an .npz of the JAX package's (HWIO) params."""
        with np.load(path) as data:
            params = params_from_jax({k: data[k] for k in data.files})
        return cls(params, cfg, device)

    @classmethod
    def from_default_weights(cls, cfg: PipelineConfig, device: torch.device):
        if not DEFAULT_WEIGHTS.exists():
            raise FileNotFoundError(f"{DEFAULT_WEIGHTS} is missing")
        return cls.from_weights(DEFAULT_WEIGHTS, cfg, device)

    def _coeff_table(self, mx: int) -> torch.Tensor:
        """(mx, out, mx) float64 PIL tap-weight table for canvas size mx,
        uploaded once per canvas size as int32 and kept on the device."""
        t = self._coeff_tables.get(mx)
        if t is None:
            w = resize_coeffs(np.arange(1, mx + 1, dtype=np.int32), mx, self.cfg.cnn_resize_to)
            (t,) = upload([w], self.device)
            t = t.to(torch.float64)
            self.upload_bytes += w.nbytes
            self._coeff_tables[mx] = t
        return t

    def _padded_n(self, n: int) -> int:
        """Batch rows for n crops: the next power of two up to
        cnn_batch_cap, else whole multiples of the cap (a handful of shapes
        for the convolutions' algorithm caches)."""
        cap = self.cfg.cnn_batch_cap
        if n <= cap:
            padded_n = 1
            while padded_n < n:
                padded_n *= 2
            return min(padded_n, cap)
        return -(-n // cap) * cap

    def _canvas_bucket(self, images) -> int:
        """Smallest canvas (32 or cnn_max_seg_hw) that holds every crop;
        0 when none does (the host PIL path).  The bucket changes no
        result (padding taps weigh 0); it cuts upload bytes."""
        m = max(max(im.shape[0], im.shape[1]) for im in images)
        for b in (32, self.cfg.cnn_max_seg_hw):
            if m <= b:
                return b
        return 0

    def classify_images(self, images: Sequence[np.ndarray], timers=None) -> np.ndarray:
        """Keep-mask (bool (n,)) of raw segment crops, from one forward.

        timers: optional dict that accumulates wall seconds under
        'classify_pack' (host packing) and 'classify_device' (upload,
        preprocess, forward and the labels' read-back)."""
        if not images:
            return np.zeros((0,), bool)
        n = len(images)
        padded_n = self._padded_n(n)
        mx = self._canvas_bucket(images) if self.cfg.cnn_device_preprocess else 0
        t0 = time.perf_counter()
        if mx:
            canv, hs, ws = pack_canvases(images, mx)
            if padded_n != n:
                canv = np.concatenate([canv, np.zeros((padded_n - n, mx, mx, 3), np.uint8)])
                # size-1 padding rows keep the coefficient normalizer from 0/0
                hs = np.concatenate([hs, np.ones(padded_n - n, np.int32)])
                ws = np.concatenate([ws, np.ones(padded_n - n, np.int32)])
            table = self._coeff_table(mx)
            t1 = time.perf_counter()
            canv_d, meta_d = upload([canv, np.stack([hs, ws])], self.device)
            pred = classify_canvases(self.params, canv_d, table, meta_d[0], meta_d[1], self.cfg)
            pred = pred.cpu().numpy()
            self.upload_bytes += canv.nbytes + hs.nbytes + ws.nbytes
        else:
            host = np.zeros((padded_n, self.cfg.cnn_input_size, self.cfg.cnn_input_size, 3),
                            np.float32)
            for i, im in enumerate(images):
                host[i] = preprocess_segment(im, self.cfg)
            t1 = time.perf_counter()
            (batch,) = upload([host], self.device)
            pred = predict(self.params, batch.permute(0, 3, 1, 2)).cpu().numpy()
            self.upload_bytes += host.nbytes
        _add_seconds(timers, "classify_pack", t1 - t0)
        _add_seconds(timers, "classify_device", time.perf_counter() - t1)
        return pred[:n] == 1

    def _frame_images(self, table, index, frame_bgr, crop_region):
        """Segment crops of one frame in ascending label order, and their
        degenerate flags.  A degenerate (empty-slice) crop is None: the
        reference would crash on it (segment_classification.py:26-33); it
        is dropped."""
        if isinstance(index, tuple):
            def get(a):
                return np.asarray(a[index[0], index[1]])
        else:
            def get(a):
                return np.asarray(a[index])
        ks = np.nonzero(get(table.valid))[0]
        if len(ks) == 0:
            return [], []
        min_y, min_x = get(table.min_y), get(table.min_x)
        max_y, max_x = get(table.max_y), get(table.max_x)
        images, degenerate = [], []
        for k in ks:
            img = extract_segment_image(
                frame_bgr, (min_y[k], min_x[k], max_y[k], max_x[k]),
                crop_region, self.cfg.min_seg_size)
            degenerate.append(img.size == 0)
            images.append(img if img.size else None)
        return images, degenerate

    @staticmethod
    def _spread(degenerate, keep_pred, j: int):
        """Keep list over one frame's segments (degenerate ones False) from
        the flat predictions starting at j; returns (keep, next j)."""
        keep = []
        for is_degenerate in degenerate:
            if is_degenerate:
                keep.append(False)
            else:
                keep.append(bool(keep_pred[j]))
                j += 1
        return keep, j

    def batch_call(self, table, frames, crop_region, timers=None):
        """Keep-masks of many frames from one forward.

        frames: {(b, t): full-resolution BGR frame} for every frame with a
        valid segment.  Returns {(b, t): keep list in ascending label
        order}, equal to per-frame __call__ (inference is per image).
        timers: optional dict; adds 'classify_crop' (host crop extraction)
        to classify_images' keys."""
        t0 = time.perf_counter()
        keys = sorted(frames.keys())
        per_frame, all_images = {}, []
        for key in keys:
            images, degenerate = self._frame_images(table, key, frames[key], crop_region)
            per_frame[key] = degenerate
            all_images.extend(im for im in images if im is not None)
        _add_seconds(timers, "classify_crop", time.perf_counter() - t0)
        keep_pred = self.classify_images(all_images, timers=timers)
        out, j = {}, 0
        for key in keys:
            out[key], j = self._spread(per_frame[key], keep_pred, j)
        return out

    def __call__(self, table, index, frame_bgr: np.ndarray, crop_region) -> List[bool]:
        """Keep-mask of frame `index`'s valid segments (ascending label order)."""
        images, degenerate = self._frame_images(table, index, frame_bgr, crop_region)
        if not images:
            return []
        keep_pred = self.classify_images([im for im in images if im is not None])
        return self._spread(degenerate, keep_pred, 0)[0]
