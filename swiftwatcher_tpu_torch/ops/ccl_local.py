"""K3: whole-frame label convergence.

Counterpart of swiftwatcher_tpu/ops/pallas/ccl_local.py:converge_frames.
Floods each frame of an (N, H, W) f32 label batch to its exact fixpoint
under its bool foreground.  The TPU kernel and the plain version here run
super-sweeps of

    3x3 min sweep -> segmented running min along rows (left to right,
    then right to left) -> along columns (top to bottom, then bottom to top)

until a super-sweep changes nothing or `max_iters` have run.  A run is a
stretch of foreground; labels never cross background.  A component then
converges in about as many super-sweeps as its geodesic has changes of
direction.  The slow path of label_components (ops/ccl.py) runs it on
label planes and on rank planes, whose values lie in [0, sentinel].

That fixpoint has a closed form: with v the first 3x3 min step (for a
foreground p, the min of the input over p's 3x3 window inside the frame),
a foreground pixel gets the min of v over its 8-connected foreground
component and a background pixel the sentinel.  On a CUDA tensor
`converge_frames` launches csrc/ccl_local.cu, which computes that closed
form by a union-find, so its cost does not depend on a component's shape.

Cap semantics: `max_iters` == 0 returns the input on either device.  For
`max_iters` >= 1 the kernel always gives the fixpoint, bit-equal to the
plain version wherever the plain version reaches it within the cap; where
the plain version would stop at its cap first, the kernel gives the
fixpoint instead.  label_components (ops/ccl.py) then finds the frame
settled and skips its pointer-jump insurance, whose result is that same
fixpoint, so its labels are the same either way.

On a CPU tensor `converge_frames` runs `converge_frames_reference`, which
scans by log-doubling as the TPU kernel does.
"""

from __future__ import annotations

import torch

from .. import build
from .ccl_sweep import min_sweep


def _shift(a: torch.Tensor, k: int, dim: int, fill, forward: bool) -> torch.Tensor:
    """out[p] = a[p - k] along `dim` when forward (fill at the low edge),
    a[p + k] when backward."""
    L = a.shape[dim]
    shape = list(a.shape)
    shape[dim] = k
    blk = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    if forward:
        return torch.cat([blk, a.narrow(dim, 0, L - k)], dim)
    return torch.cat([a.narrow(dim, k, L - k), blk], dim)


def _seg_min_scan(
    v: torch.Tensor, bg: torch.Tensor, sentinel: float, dim: int, forward: bool
) -> torch.Tensor:
    """Running min along `dim` within foreground runs (log-doubling over
    (value, window-holds-a-gap) pairs)."""
    b = bg
    k = 1
    while k < v.shape[dim]:
        vs = _shift(v, k, dim, sentinel, forward)
        bs = _shift(b, k, dim, True, forward)
        v = torch.where(b, v, torch.minimum(v, vs))
        b = b | bs
        k <<= 1
    return v


def converge_frames_reference(
    lbl: torch.Tensor, fg: torch.Tensor, max_iters: int, sentinel: float
) -> torch.Tensor:
    """Plain PyTorch version of K3.  Frames at their fixpoint stay there,
    so sweeping the batch until no frame changes gives each frame its own
    count of super-sweeps, as the per-frame kernel does."""
    bg = ~fg
    changed, it = True, 0
    while changed and it < max_iters:
        new = min_sweep(lbl, fg, sentinel)
        for dim, forward in ((2, True), (2, False), (1, True), (1, False)):
            new = _seg_min_scan(new, bg, sentinel, dim, forward)
        changed = bool((new != lbl).any())
        lbl, it = new, it + 1
    return lbl


def converge_frames(
    lbl: torch.Tensor, fg: torch.Tensor, max_iters: int, sentinel: float
) -> torch.Tensor:
    """(N, H, W) f32 labels in [0, sentinel] + bool fg -> labels at the
    per-frame fixpoint (on the CPU, after at most `max_iters`
    super-sweeps; see the module docstring for the cap)."""
    if lbl.device.type == "cpu":
        return converge_frames_reference(lbl, fg, max_iters, sentinel)
    build.check_operand("converge_frames", lbl, torch.float32)
    build.check_operand("converge_frames", fg, torch.bool, like=lbl)
    N, H, W = lbl.shape
    if H * W >= 1 << 24:
        raise ValueError("converge_frames: crop too large for exact f32 labels")
    if max_iters < 0:
        raise ValueError(f"converge_frames: max_iters must be >= 0, got {max_iters}")
    out = torch.empty_like(lbl)
    if N == 0:
        return out
    scratch = torch.empty_like(lbl)
    build.launch(
        "ccl_local", "swt_converge_frames", lbl.device,
        lbl.data_ptr(), fg.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        N, H, W, max_iters, float(sentinel),
    )
    converge_frames.launches += 1
    return out


converge_frames.launches = 0
