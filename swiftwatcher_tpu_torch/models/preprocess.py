"""Classifier preprocessing on the device: PIL's antialiased bilinear resize
as exact products over zero-padded canvases.

Counterpart of swiftwatcher_tpu/models/preprocess.py.  The reference
preprocesses each segment through torchvision's ToPILImage -> Resize((24,
24)) -> ToTensor -> Normalize (segment_classification.py:18-24).  PIL's
bilinear resize is antialiased: the filter support grows with the
downsampling ratio, the normalized tap weights are quantized to 22-bit
fixed point, and the image is resampled horizontally into a uint8
intermediate, then vertically (Pillow Resample.c).

The tap weights depend only on a crop's (h, w); `resize_coeffs` computes
them on the host in float64 with PIL's arithmetic, bit-identical to
Pillow's.  With every crop zero-padded into a fixed canvas, padding taps
get weight 0, and the two passes are batched products.

Exactness: PIL accumulates coefficient x pixel in an int32.  CUDA's matrix
products take no integer operands, so `preprocess_batch` runs them in
float64: every term is below 2^30 and every partial sum is an integer below
255 * 2^22 < 2^31 < 2^53, so float64 is exact in any summation order and
the result is PIL's, byte for byte, on every device.  (float32 is not: the
JAX package measured 0.6% of pixels flipping on rounding half-boundaries.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig

# PIL quantizes normalized tap weights to this fixed-point precision
# (Pillow src/libImaging/Resample.c: PRECISION_BITS = 32 - 8 - 2).
_PRECISION = 22


def resize_coeffs(sizes: np.ndarray, max_in: int, out_size: int) -> np.ndarray:
    """Per-segment PIL-bilinear tap-weight matrices, (N, out_size, max_in)
    int32 in 22-bit fixed point; taps at index >= size get weight 0, so a
    zero-padded canvas reproduces PIL's edge handling."""
    sizes = np.asarray(sizes, np.int64)
    scale = sizes.astype(np.float64)[:, None] / out_size            # (N, 1)
    fscale = np.maximum(scale, 1.0)
    centers = (np.arange(out_size, dtype=np.float64) + 0.5)[None, :] * scale
    j = np.arange(max_in, dtype=np.float64)
    # bilinear filter f(x) = max(0, 1 - |x|), stretched by the filter scale
    w = 1.0 - np.abs(
        (j[None, None, :] + 0.5 - centers[:, :, None]) / fscale[:, :, None]
    )
    np.clip(w, 0.0, None, out=w)
    w *= j[None, None, :] < sizes[:, None, None]
    w /= np.sum(w, axis=-1, keepdims=True)
    # PIL: kk[x] = (int)(k * (1 << 22) + 0.5) for k >= 0 (all bilinear taps)
    return np.floor(w * (1 << _PRECISION) + 0.5).astype(np.int32)


def _shift_u8(ss: torch.Tensor) -> torch.Tensor:
    # PIL: clip8((sum + (1 << 21)) >> 22), round half up, then clamp
    s = ss.to(torch.int64)
    return ((s + (1 << (_PRECISION - 1))) >> _PRECISION).clamp_(0, 255).to(torch.float64)


def preprocess_batch(
    crops: torch.Tensor,      # (N, MAXH, MAXW, 3) uint8 zero-padded canvases
    wh: torch.Tensor,         # (N, out, MAXW) fixed-point h tap weights
    wv: torch.Tensor,         # (N, out, MAXH) fixed-point v tap weights
    cfg: PipelineConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Segment canvases -> (N, 3, 224, 224) float32 normalized network input,
    bit-equal to preprocess_segment's (PIL on the host) on every device.

    The antialiased 24x24 resize (horizontal pass, uint8 round, vertical
    pass, uint8 round), zero-pad to 224, scale to [0, 1], ImageNet
    normalize, keeping the reference's quirk: the BGR bytes pass through as
    if they were RGB.  The tap weights may come in any dtype that holds
    them exactly (the filter keeps its table in float64)."""
    img = crops.to(torch.float64)
    wh = wh.to(torch.float64)
    wv = wv.to(torch.float64)
    # horizontal pass first, uint8 intermediate between passes (PIL order)
    tmp = _shift_u8(torch.einsum("now,nhwc->nhoc", wh, img))
    small = _shift_u8(torch.einsum("noh,nhwc->nowc", wv, tmp))
    dev = crops.device
    small = small.to(torch.float32).permute(0, 3, 1, 2) / _channels((255.0,), dev)
    pad = (cfg.cnn_input_size - cfg.cnn_resize_to) // 2
    rest = cfg.cnn_input_size - cfg.cnn_resize_to - pad
    full = torch.nn.functional.pad(small, (pad, rest, pad, rest))
    return (full - _channels(cfg.cnn_mean, dev)) / _channels(cfg.cnn_std, dev)


@functools.lru_cache(maxsize=None)
def _channels(values, device: torch.device) -> torch.Tensor:
    """(1, C, 1, 1) float32 constants made on `device` by fills.  A copy
    from pageable host memory would make the host wait for the stream, and
    CUDA divides by a Python scalar as a product with its reciprocal: with
    device constants every step is one IEEE f32 operation, as numpy's on
    the host PIL path (preprocess_segment), on every device."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device)
                        for v in values]).view(1, -1, 1, 1)


def pack_canvases(images, max_hw: int):
    """Variable-size uint8 crops -> one zero-padded (N, max_hw, max_hw, 3)
    canvas batch and the true (h, w) vectors, in numpy on the host."""
    n = len(images)
    canv = np.zeros((n, max_hw, max_hw, 3), np.uint8)
    hs = np.empty((n,), np.int32)
    ws = np.empty((n,), np.int32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        canv[i, :h, :w] = im
        hs[i], ws[i] = h, w
    return canv, hs, ws
