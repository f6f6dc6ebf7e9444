"""K2 and K4: connected-component labelling and rank compaction.

Counterpart of swiftwatcher_tpu/ops/pallas/rank_compact.py.

K2, `label_rank_fused`, is the whole labelling of the fast path.  Per frame
of an (N, H, W) bool foreground batch: seed labels with the raster index
(background = sentinel H*W), run `sweeps` Jacobi 3x3 min sweeps under fg,
certify the fixpoint with one probe sweep, rank the roots by a raster-order
count, seed the ranks and sweep them `sweeps` times.  Returns (swept f32
labels, compact int32 labels with background 0, (N,) bool "not converged"
flag).  A converged frame's compact labels are exact (the rank flood
propagates from the same unique roots as the label flood); a flagged frame
must be recomputed by the caller (ops/ccl.py).

K4, `rank_seed_sweep`, is the compaction half alone, for the slow path:
converged f32 labels (foreground = label < sentinel) -> seeded ranks ->
exactly `sweeps` sweeps -> (f32 rank map with background = sentinel, (N,)
bool "unsettled" flag: whether one more sweep would change the map).  The
sweeps are run, not replaced by a gather of each pixel's root rank, which
on a component deeper than `sweeps` would give the fixpoint instead.

On a CUDA tensor each wrapper launches csrc/rank_compact.cu; on a CPU
tensor it runs its `*_reference` version.  Both kernels work on tiles of
`K2_TILE` pixels, each staged with a halo in shared memory
(csrc/tile_sweep.cuh), and rank by root counts per (row, `K2_SEGMENT`-column
segment) of a frame and a per-frame scan of them.  On a frame it does not
flag K2 gathers each pixel's root rank instead of flooding the ranks: the
flood's result there is that rank.  K4 floods on every tile with
foreground, with a halo one wider than its sweeps, and ends each tile with
one probe sweep on the tile's own cells for the flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import build
from .ccl_sweep import min_sweep, sweep_chunk_reference

# Sweeps per flood stage, as the JAX package's RANK_SWEEPS: covers
# components of flood distance <= 12 (single blobs and merged pairs).
RANK_SWEEPS = 12

# K2's and K4's kernels: output tile (rows, columns), the columns of one
# root count (a warp ballot), and the most sweeps their shared-memory halo
# allows.
K2_TILE = (32, 64)
K2_SEGMENT = 32
K2_MAX_SWEEPS = 32


def raster_index(H: int, W: int, device) -> torch.Tensor:
    """(H, W) f32 raster index, exact below 2^24 pixels."""
    return torch.arange(H * W, device=device, dtype=torch.float32).reshape(H, W)


def _seed_ranks(lbl: torch.Tensor, fg: torch.Tensor, P: float) -> torch.Tensor:
    """Roots (fg pixels labelled with their own raster index) get their
    1-based raster-order rank; every other pixel gets P."""
    N, H, W = lbl.shape
    is_root = fg & (lbl == raster_index(H, W, lbl.device))
    csum = torch.cumsum(is_root.flatten(1).to(torch.int32), dim=1).reshape(N, H, W)
    return torch.where(is_root, csum.to(torch.float32), torch.full_like(lbl, P))


def label_rank_fused_reference(
    fg: torch.Tensor, sweeps: int = RANK_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, same outputs."""
    N, H, W = fg.shape
    P = float(H * W)
    idx = raster_index(H, W, fg.device)
    lbl = sweep_chunk_reference(torch.where(fg, idx, torch.full_like(idx, P)), fg, sweeps, P)[0]
    flag = (min_sweep(lbl, fg, P) != lbl).flatten(1).any(dim=1)
    rank = sweep_chunk_reference(_seed_ranks(lbl, fg, P), fg, sweeps, P)[0]
    labels = torch.where(fg, rank, torch.zeros_like(rank)).to(torch.int32)
    return lbl, labels, flag


def label_rank_fused(
    fg: torch.Tensor, sweeps: int = RANK_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, H, W) bool fg -> (swept f32 labels, int32 labels, (N,) bool flag)."""
    if fg.device.type == "cpu":
        return label_rank_fused_reference(fg, sweeps)
    build.check_operand("label_rank_fused", fg, torch.bool)
    N, H, W = fg.shape
    if H * W >= 1 << 24:
        raise ValueError("label_rank_fused: crop too large for exact f32 labels")
    if not 0 <= sweeps <= K2_MAX_SWEEPS:
        raise ValueError(f"label_rank_fused: sweeps must be 0..{K2_MAX_SWEEPS}, got {sweeps}")
    lbl = torch.empty((N, H, W), dtype=torch.float32, device=fg.device)
    labels = torch.empty((N, H, W), dtype=torch.int32, device=fg.device)
    flag = torch.empty((N,), dtype=torch.uint8, device=fg.device)
    if N == 0:
        return lbl, labels, flag.bool()
    # root counts, then root bits, per (frame, row, segment)
    counts = torch.empty((2, N, H, -(-W // K2_SEGMENT)), dtype=torch.int32, device=fg.device)
    build.launch(
        "rank_compact", "swt_label_rank_fused", fg.device,
        fg.data_ptr(), lbl.data_ptr(), labels.data_ptr(), counts.data_ptr(),
        flag.data_ptr(), N, H, W, sweeps,
    )
    label_rank_fused.launches += 1
    return lbl, labels, flag.bool()


label_rank_fused.launches = 0


def rank_seed_sweep_reference(
    lbl: torch.Tensor, sweeps: int = RANK_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4, same outputs."""
    N, H, W = lbl.shape
    P = float(H * W)
    fg = lbl < P
    rank = sweep_chunk_reference(_seed_ranks(lbl, fg, P), fg, sweeps, P)[0]
    return rank, (min_sweep(rank, fg, P) != rank).flatten(1).any(dim=1)


def rank_seed_sweep(
    lbl: torch.Tensor, sweeps: int = RANK_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) converged f32 labels -> (f32 rank map after `sweeps`
    sweeps, (N,) bool "unsettled")."""
    if lbl.device.type == "cpu":
        return rank_seed_sweep_reference(lbl, sweeps)
    build.check_operand("rank_seed_sweep", lbl, torch.float32)
    N, H, W = lbl.shape
    if H * W >= 1 << 24:
        raise ValueError("rank_seed_sweep: crop too large for exact f32 labels")
    if not 0 <= sweeps <= K2_MAX_SWEEPS:
        raise ValueError(f"rank_seed_sweep: sweeps must be 0..{K2_MAX_SWEEPS}, got {sweeps}")
    out = torch.empty_like(lbl)
    unsettled = torch.empty((N,), dtype=torch.bool, device=lbl.device)
    if N == 0:
        return out, unsettled
    # root counts, then root bits, per (frame, row, segment)
    counts = torch.empty((2, N, H, -(-W // K2_SEGMENT)), dtype=torch.int32, device=lbl.device)
    build.launch(
        "rank_compact", "swt_rank_seed_sweep", lbl.device,
        lbl.data_ptr(), out.data_ptr(), counts.data_ptr(), unsettled.data_ptr(),
        N, H, W, sweeps,
    )
    rank_seed_sweep.launches += 1
    return out, unsettled


rank_seed_sweep.launches = 0
