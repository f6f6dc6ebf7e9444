"""The segment filter, plainly: SqueezeNet 1.0 with a 2-class head.

The original's SegmentClassifier (segment_classification.py:14-44) keeps a
segment when its network's argmax is 1.  Each segment's box is expanded to
at least `min_seg_size`, centred, the extra split floor/ceil
(image_filtering.py:350-358), and sliced from the whole frame at the crop
region's origin (image_filtering.py:360-365); then the transform stack:
the BGR bytes read by PIL as RGB, resized to `cnn_resize_to` squared
(bilinear), zero-padded to `cnn_input_size`, over 255 and normalised by
the ImageNet mean and deviation.  An empty slice, which would stop the
original, is rejected here.

The network is torchvision's squeezenet1_0 (Iandola et al.,
arXiv:1602.07360) with the classifier's convolution cut to 2 outputs, in
eval mode (dropout is the identity), written out in plain torch.  Its
weights are read from an .npz of HWIO convolutions with numpy and turned
OIHW here.  `precision="float64"` runs it in float64; `"tf32"` is the
control, float32 convolutions whose operands are first rounded to TF32, as
a TF32 convolution rounds them.  TF32 is switched off in torch either way.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .ialm import tf32_round

# features.<index>: (squeeze, expand 1x1, expand 3x3) of each fire module;
# max pools (3, stride 2, ceil) at 2, 6 and 11; features.0 is the 7x7/2 stem
FIRES = {3: (16, 64, 64), 4: (16, 64, 64), 5: (32, 128, 128), 7: (32, 128, 128),
         8: (48, 192, 192), 9: (48, 192, 192), 10: (64, 256, 256), 12: (64, 256, 256)}
POOLS = (2, 6, 11)
# crops a forward at a time
BLOCK = 64


def load_weights(path: Path, device) -> Dict[str, torch.Tensor]:
    """The .npz's arrays as float64 tensors, convolutions HWIO -> OIHW."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = np.asarray(data[k], np.float64)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "float64"):
    """(N, 3, S, S) normalised input -> (N, 2) logits."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dtype = torch.float64 if precision == "float64" else torch.float32

    def conv(x, key, **kw):
        weight, bias = w[f"{key}.weight"].to(dtype), w[f"{key}.bias"].to(dtype)
        if precision == "tf32":
            x, weight = tf32_round(x), tf32_round(weight)
        return F.relu(F.conv2d(x, weight, bias, **kw))

    x = x.to(dtype)
    x = conv(x, "features.0", stride=2)
    for i in range(1, 13):
        if i in POOLS:
            x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
        elif i in FIRES:
            s = conv(x, f"features.{i}.squeeze")
            x = torch.cat([conv(s, f"features.{i}.expand1x1"),
                           conv(s, f"features.{i}.expand3x3", padding=1)], dim=1)
    return conv(x, "classifier.1").mean(dim=(2, 3))


def expand_box(box: Sequence[int], min_size: Sequence[int]) -> List[int]:
    """[y1, x1, y2, x2] grown to at least min_size, centred: floor of the
    extra above and left, ceil below and right."""
    y1, x1, y2, x2 = (int(v) for v in box)
    if y2 - y1 < min_size[0]:
        d = min_size[0] - (y2 - y1)
        y1, y2 = y1 - math.floor(d / 2), y2 + math.ceil(d / 2)
    if x2 - x1 < min_size[1]:
        d = min_size[1] - (x2 - x1)
        x1, x2 = x1 - math.floor(d / 2), x2 + math.ceil(d / 2)
    return [y1, x1, y2, x2]


def network_input(frame: np.ndarray, box, origin, p: dict) -> Optional[np.ndarray]:
    """The (3, S, S) float64 input of the segment in `box` (crop
    coordinates, bottom and right exclusive) of the whole BGR `frame`, the
    crop region's top-left corner at `origin` (x, y); None for an empty
    slice."""
    from PIL import Image

    y1, x1, y2, x2 = expand_box(box, p["min_seg_size"])
    ox, oy = origin
    img = frame[y1 + oy:y2 + oy, x1 + ox:x2 + ox]
    if img.size == 0:
        return None
    r, S = int(p["cnn_resize_to"]), int(p["cnn_input_size"])
    small = Image.fromarray(np.ascontiguousarray(img)).resize((r, r), Image.BILINEAR)
    full = np.zeros((S, S, 3), np.float64)
    pad = (S - r) // 2
    full[pad:pad + r, pad:pad + r] = np.asarray(small, np.float64) / 255.0
    full = (full - np.asarray(p["cnn_mean"], np.float64)) / np.asarray(p["cnn_std"], np.float64)
    return full.transpose(2, 0, 1)


def logits(weights: Dict[str, torch.Tensor], inputs: List[np.ndarray],
           precision: str = "float64") -> np.ndarray:
    """(N, 2) float64 logits of the inputs, BLOCK at a time."""
    out = np.zeros((len(inputs), 2), np.float64)
    device = weights["features.0.weight"].device
    for s in range(0, len(inputs), BLOCK):
        x = torch.from_numpy(np.stack(inputs[s:s + BLOCK])).to(device)
        out[s:s + BLOCK] = forward(weights, x, precision).double().cpu().numpy()
    return out
