"""SqueezeNet 1.0 with a 2-class head, as functions over a state dict.

Counterpart of swiftwatcher_tpu/models/squeezenet.py: torchvision's
squeezenet1_0 graph as the reference modifies it (classifier conv 512 ->
num_classes), in eval mode (dropout is the identity), NCHW, with the
weights keyed by the torch state_dict names and held OIHW.

    conv 7x7/2 (96) -> relu -> maxpool 3/2 ceil
    fire(16, 64, 64) fire(16, 64, 64) fire(32, 128, 128) -> maxpool 3/2 ceil
    fire(32, 128, 128) fire(48, 192, 192) fire(48, 192, 192)
    fire(64, 256, 256) -> maxpool 3/2 ceil -> fire(64, 256, 256)
    dropout -> conv 1x1 (num_classes) -> relu -> global avg pool -> flatten

The convolutions are cuDNN's on a card.  `predict` pins full-f32 numerics
(`device.pin_numerics`) before every forward there: TF32 convolutions
drift the logits by about 2e-2, enough to flip the argmax of near-tie
segments (the JAX package runs its convolutions at Precision.HIGHEST for
the same reason).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import pin_numerics
from ..utils.metrics import span

# (feature index, squeeze, expand1x1, expand3x3) per fire module,
# torchvision 1.0 layout.
FIRE_LAYOUT: Tuple[Tuple[int, int, int, int], ...] = (
    (3, 16, 64, 64),
    (4, 16, 64, 64),
    (5, 32, 128, 128),
    (7, 32, 128, 128),
    (8, 48, 192, 192),
    (9, 48, 192, 192),
    (10, 64, 256, 256),
    (12, 64, 256, 256),
)
POOL_AFTER = {2, 6, 11}  # maxpool positions in the features Sequential


def _conv(x, params, key, stride=1, padding=0):
    return F.conv2d(x, params[f"{key}.weight"], params[f"{key}.bias"],
                    stride=stride, padding=padding)


def features(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The feature trunk: (N, 3, 224, 224) float32 input -> (N, 512, 13, 13)."""
    x = F.relu(_conv(x, params, "features.0", stride=2))
    fire_at = {idx: cfg for idx, *cfg in FIRE_LAYOUT}
    for idx in range(1, 13):
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
        elif idx in fire_at:
            s = F.relu(_conv(x, params, f"features.{idx}.squeeze"))
            e1 = F.relu(_conv(s, params, f"features.{idx}.expand1x1"))
            e3 = F.relu(_conv(s, params, f"features.{idx}.expand3x3", padding=1))
            x = torch.cat([e1, e3], dim=1)
    return x


def forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(N, 3, 224, 224) float32 normalized input -> (N, num_classes) logits."""
    x = F.relu(_conv(features(params, x), params, "classifier.1"))
    return x.mean(dim=(2, 3))  # AdaptiveAvgPool2d((1, 1)) + flatten


def predict(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """argmax class per example (segment_classification.py:36), (N,) int64.
    The forward and its argmax are the span `classify_forward`, a range of
    that name under a profiler, on every classify path."""
    if x.is_cuda:
        pin_numerics()
    with span("classify_forward"):
        return forward(params, x).argmax(dim=1)


def params_from_jax(params: Mapping[str, np.ndarray], device=torch.device("cpu"),
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's params (HWIO convs, e.g. segment_classifier.npz)
    -> a state dict of float32 OIHW tensors on `device`."""
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of params_from_jax: OIHW tensors -> HWIO float32 arrays."""
    out = {}
    for k, t in state.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        out[k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def random_params(rng: np.random.Generator, num_classes: int = 2,
                  device=torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """He-initialized state dict, drawn in the JAX package's order, so that
    random_params(default_rng(s)) equals params_from_jax of its
    random_params(default_rng(s))."""
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, cin, cout):
        fan_in = kh * kw * cin
        params[f"{key}.weight"] = (
            rng.standard_normal((kh, kw, cin, cout)) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        params[f"{key}.bias"] = np.zeros((cout,), np.float32)

    conv("features.0", 7, 7, 3, 96)
    cin = 96
    for idx, sq, e1, e3 in FIRE_LAYOUT:
        conv(f"features.{idx}.squeeze", 1, 1, cin, sq)
        conv(f"features.{idx}.expand1x1", 1, 1, sq, e1)
        conv(f"features.{idx}.expand3x3", 3, 3, sq, e3)
        cin = e1 + e3
    conv("classifier.1", 1, 1, 512, num_classes)
    return params_from_jax(params, device)
