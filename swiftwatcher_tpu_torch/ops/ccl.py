"""8-connected component labelling of (T, H, W) bool batches.

Counterpart of swiftwatcher_tpu/ops/ccl.py:label_components on its TPU
path.  Labels are numbered 1..n per frame in raster-first-occurrence order
(a component's root is its minimum raster index, its first pixel in raster
order), with background 0: the same values the JAX package gives on any
backend.

  * Fast path: K2 (ops/rank_compact.py) labels every frame in one pass and
    flags the frames whose label flood did not reach its fixpoint within
    RANK_SWEEPS sweeps (giant merges, snakes).
  * Slow path, flagged frames only, from K2's swept labels: chunks of 4
    sweeps (K5, ops/ccl_sweep.py) up to 24 sweeps, each chunk's "changed"
    flag deciding whether another runs; then, if the flood has not
    settled, the whole-frame convergence (K3, ops/ccl_local.py), a 1-sweep
    K5 launch as its check and, should that find the frame unsettled,
    pool + pointer-jump rounds.  Compaction then ranks the converged roots
    and floods the ranks (K4, ops/rank_compact.py), whose "unsettled" flag
    decides whether K5 chunks and K3 finish the flood the same way, and as
    a last resort maps each pixel to its root's rank by one gather.

The JAX package runs the slow path on the whole batch when any frame is
flagged; here it runs on the flagged frames alone.  Every step leaves a
converged frame as it is, so the labels are the same.  The kernels' flags
take the place of the JAX package's whole-plane compares (`verify_fixpoint`
and `any(new != lbl)`), each read by one host sync.

`label_components.slow_path_frames` counts the frames the slow path took.
Each host read of a flag (the flagged frames, each chunk's or check's
"changed") is a `sync.ccl_flag` span of the run's metrics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.metrics import span
from .ccl_local import converge_frames
from .ccl_sweep import sweep_chunk
from .rank_compact import RANK_SWEEPS, label_rank_fused, rank_seed_sweep, raster_index

# Sweeps per convergence check, and the sweep budget of a flood before the
# super-sweeps take over (the JAX package's CHUNK and phase-1 budget).
_CHUNK = 4
_FLOOD_SWEEPS = 24


def _any(flags: torch.Tensor) -> bool:
    """Whether any of `flags` is set: one host read of the device."""
    with span("sync.ccl_flag"):
        return bool(flags.any())


def _unsettled(x: torch.Tensor, fg: torch.Tensor, sentinel: float) -> bool:
    """True if another sweep would still change `x`."""
    return _any(sweep_chunk(x, fg, 1, sentinel)[1])


def _flood(
    x: torch.Tensor, fg: torch.Tensor, sentinel: float, changed: bool
) -> Tuple[torch.Tensor, bool]:
    """K5 chunks until nothing changes or the sweep budget is spent."""
    it = 0
    while changed and it < _FLOOD_SWEEPS:
        x, ch = sweep_chunk(x, fg, _CHUNK, sentinel)
        changed = _any(ch)
        it += _CHUNK
    return x, changed


def _converge(
    x: torch.Tensor, fg: torch.Tensor, sentinel: float, changed: bool, max_iters: int
) -> Tuple[torch.Tensor, bool]:
    """K3 on an unsettled flood, then report whether it is still unsettled.

    Only the plain version (a CPU tensor) can stop at its `max_iters` cap
    unsettled; the kernel gives the fixpoint for any cap >= 1, so on the
    card this reports settled and the callers skip their insurance (pointer
    jumping, the rank gather), which would reach that same fixpoint."""
    if changed:
        x = converge_frames(x, fg, max_iters, sentinel)
        changed = _unsettled(x, fg, sentinel)
    return x, changed


def _settle_labels(
    lbl: torch.Tensor, fg: torch.Tensor, sentinel: float, max_iters: int
) -> torch.Tensor:
    """Flood partially swept labels to their exact fixpoint."""
    lbl, changed = _flood(lbl, fg, sentinel, True)
    lbl, changed = _converge(lbl, fg, sentinel, changed, max_iters)
    # Pointer jumping: each round is one halving step of the label forest,
    # and counts one unit against max_iters (a safety bound: the operator
    # is monotone decreasing).
    T = lbl.shape[0]
    tail = torch.full((T, 1), sentinel, dtype=lbl.dtype, device=lbl.device)
    it = 0
    while changed and it < max_iters:
        cand = sweep_chunk(lbl, fg, _CHUNK, sentinel)[0].reshape(T, -1)
        jumped = torch.cat([cand, tail], dim=1).gather(1, cand.long())
        new = torch.where(fg, jumped.reshape(lbl.shape), torch.full_like(lbl, sentinel))
        changed = _any(new != lbl)
        lbl, it = new, it + 1
    return lbl


def _rank_map(
    lbl: torch.Tensor, fg: torch.Tensor, sentinel: float, max_iters: int
) -> torch.Tensor:
    """Converged labels -> f32 map of each pixel's root rank (bg sentinel)."""
    rank, unsettled = rank_seed_sweep(lbl, RANK_SWEEPS)
    rank, changed = _flood(rank, fg, sentinel, _any(unsettled))
    rank, changed = _converge(rank, fg, sentinel, changed, max_iters)
    if changed:
        # pathological components: rank[root[p]] by one gather
        T, H, W = lbl.shape
        is_root = fg & (lbl == raster_index(H, W, lbl.device))
        ranks = torch.cumsum(is_root.reshape(T, -1).to(torch.int32), dim=1).to(torch.float32)
        tail = torch.full((T, 1), sentinel, dtype=ranks.dtype, device=ranks.device)
        rank = torch.cat([ranks, tail], dim=1).gather(1, lbl.reshape(T, -1).long())
        rank = rank.reshape(T, H, W)
    return rank


def label_components(
    fg: torch.Tensor, max_iters: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W) bool -> (int32 labels, (T,) int32 component counts)."""
    T, H, W = fg.shape
    if H * W >= 1 << 24:
        raise ValueError("crop too large for exact f32 label propagation")
    fg = fg.contiguous()
    lbl, labels, flag = label_rank_fused(fg, RANK_SWEEPS)
    counts = labels.amax(dim=(1, 2))
    with span("sync.ccl_flag"):
        slow = flag.nonzero().squeeze(1)
    if slow.numel():
        label_components.slow_path_frames += int(slow.numel())
        sentinel = float(H * W)
        fg_s = fg[slow]
        rank = _rank_map(_settle_labels(lbl[slow], fg_s, sentinel, max_iters),
                         fg_s, sentinel, max_iters)
        labels[slow] = torch.where(fg_s, rank.to(torch.int32), 0)
        counts[slow] = torch.where(rank < sentinel, rank, 0.0).amax(dim=(1, 2)).to(torch.int32)
    return labels, counts


label_components.slow_path_frames = 0


def wrap_labels_uint8(labels: torch.Tensor, modulus: int = 256) -> torch.Tensor:
    """The reference's uint8 cast of int labels: labels mod `modulus`."""
    return (labels % modulus).to(torch.uint8)
