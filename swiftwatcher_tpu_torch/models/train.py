"""Classifier fine-tuning: transfer learning for the segment CNN.

Counterpart of swiftwatcher_tpu/models/train.py.  The reference ships
weights made by freezing SqueezeNet's features and training the 2-class
head conv (segment_classification.py:51-63).  Here the same: functions
over the port's OIHW state dict (models/squeezenet.py), torch autograd
for the head's gradients and a torch.optim.Adam over the head, with
optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8).  The update formula is
optax's; the two differ by rounding only (torch takes mu by a lerp and
divides by the bias corrections in another order).

parallel/mesh.py:sharded_train_step runs the same step over a mesh's
ranks, dp over the batch and tp over the head's 512 input channels.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import pin_numerics
from . import squeezenet

HEAD_KEYS = ("classifier.1.weight", "classifier.1.bias")


def split_params(params: Mapping[str, torch.Tensor]):
    """(trunk, head): the frozen features and the trained head conv."""
    head = {k: params[k] for k in HEAD_KEYS}
    trunk = {k: v for k, v in params.items() if k not in HEAD_KEYS}
    return trunk, head


def features(trunk: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Frozen feature trunk: (N, 3, 224, 224) -> (N, 512, h, w)."""
    return squeezenet.features(trunk, x)


def head_logits(head: Mapping[str, torch.Tensor], feats: torch.Tensor) -> torch.Tensor:
    """(N, 512, h, w) features -> (N, num_classes) logits."""
    x = F.relu(F.conv2d(feats, head[HEAD_KEYS[0]], head[HEAD_KEYS[1]]))
    return x.mean(dim=(2, 3))


def loss_fn(head, feats, labels) -> torch.Tensor:
    """Mean softmax cross-entropy of the head on integer labels."""
    return F.cross_entropy(head_logits(head, feats), labels.long())


def make_optimizer(head: Dict[str, torch.Tensor], lr: float) -> torch.optim.Adam:
    """Adam over the head's tensors, which become leaves that require grad
    (in place in `head`).  The single-tensor algorithm on every device, so
    that the card and the CPU round alike."""
    for k in HEAD_KEYS:
        head[k] = head[k].detach().clone().requires_grad_(True)
    return torch.optim.Adam([head[k] for k in HEAD_KEYS], lr=lr, foreach=False)


def make_train_step():
    """(head, opt, feats, labels) -> (head, opt, loss): one Adam step of
    the head on a batch of features, in place (opt from make_optimizer)."""

    def step(head, opt, feats, labels):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(head, feats, labels)
        loss.backward()
        opt.step()
        return head, opt, loss.detach()

    return step


def adam_state(opt: torch.optim.Adam, head) -> Tuple[int, dict, dict]:
    """(count, mu, nu) of `opt` over `head`'s tensors, in the port's layout
    (zeros before the first step)."""
    count, mu, nu = 0, {}, {}
    for k in HEAD_KEYS:
        st = opt.state.get(head[k], {})
        count = int(st["step"]) if "step" in st else 0
        mu[k] = st["exp_avg"].detach().clone() if st else torch.zeros_like(head[k]).detach()
        nu[k] = st["exp_avg_sq"].detach().clone() if st else torch.zeros_like(head[k]).detach()
    return count, mu, nu


def set_adam_state(opt: torch.optim.Adam, head, count: int, mu, nu) -> None:
    """Give `opt` the moments mu, nu (port layout) after `count` steps."""
    for k in HEAD_KEYS:
        p = head[k]
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(mu[k]).to(p.device, p.dtype).clone(),
            "exp_avg_sq": torch.as_tensor(nu[k]).to(p.device, p.dtype).clone(),
        }


def adam_state_from_optax(opt: torch.optim.Adam, head, count, mu, nu) -> None:
    """Carry optax.adam's state (its ScaleByAdamState's count, and mu and nu
    as numpy arrays keyed by HEAD_KEYS, HWIO convs) into `opt`."""
    dev = head[HEAD_KEYS[0]].device
    set_adam_state(opt, head, int(np.asarray(count)),
                   squeezenet.params_from_jax(mu, dev), squeezenet.params_from_jax(nu, dev))


def adam_state_to_optax(opt: torch.optim.Adam, head):
    """(count, mu, nu) of `opt` as optax.adam holds them: an int32 count and
    numpy arrays in the JAX package's layout."""
    count, mu, nu = adam_state(opt, head)
    return (np.asarray(count, np.int32), squeezenet.params_to_jax(mu),
            squeezenet.params_to_jax(nu))


def finetune(
    params: Mapping[str, torch.Tensor],
    images: np.ndarray,
    labels: np.ndarray,
    steps: int = 100,
    batch_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    device: torch.device = torch.device("cuda"),
) -> Dict[str, np.ndarray]:
    """Fine-tune the head on (N, 224, 224, 3) float images (NHWC, as the JAX
    package's finetune takes them) on `device`; the state dict after, as
    numpy OIHW arrays.  Batches are drawn from default_rng(seed) as the
    JAX package draws them, so both see the same batches."""
    device = torch.device(device)
    if device.type == "cuda":
        pin_numerics()
    trunk, head = split_params({k: torch.as_tensor(v, dtype=torch.float32).to(device)
                                for k, v in params.items()})
    opt = make_optimizer(head, lr)
    step = make_train_step()
    rng = np.random.default_rng(seed)
    n = len(images)
    for _ in range(steps):
        idx = rng.integers(0, n, size=batch_size)
        x = torch.from_numpy(np.ascontiguousarray(images[idx], np.float32)).to(device)
        with torch.no_grad():
            feats = features(trunk, x.permute(0, 3, 1, 2).contiguous())
        lab = torch.from_numpy(np.asarray(labels[idx], np.int64)).to(device)
        head, opt, _ = step(head, opt, feats, lab)
    out = dict(trunk)
    out.update(head)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
