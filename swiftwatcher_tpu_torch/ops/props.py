"""Region statistics as fixed-capacity padded tables.

Counterpart of swiftwatcher_tpu/ops/props.py: moments and extents of every
uint8 label value in a (..., H, W) label batch, in (..., 256) tables.  Slot
k holds the union of all components whose wrapped label is k (regionprops
on the reference's uint8 label image); slot 0, the background, is invalid.
Sums are exact integers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.metrics import span

MAX_LABELS = 256  # uint8 label domain, slot 0 = background

# Label capacity of the small table pass; batches holding a label at or
# above it take the full 256-slot pass.  Both give the same tables.
FAST_LABELS = 32


@dataclasses.dataclass(frozen=True)
class RegionTable:
    """Per-frame region statistics, (..., MAX_LABELS) each."""

    area: torch.Tensor    # int32 pixel count
    sum_y: torch.Tensor   # int32 sum of row indices
    sum_x: torch.Tensor   # int32 sum of column indices
    min_y: torch.Tensor   # int32 bbox top (inclusive)
    min_x: torch.Tensor   # int32 bbox left (inclusive)
    max_y: torch.Tensor   # int32 bbox bottom (exclusive, regionprops style)
    max_x: torch.Tensor   # int32 bbox right (exclusive)
    valid: torch.Tensor   # bool: area > 0 and label != 0

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RegionTable":
        """A table with `fn` applied to every field."""
        return RegionTable(
            **{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )


def _counts(bins: torch.Tensor, n: int) -> torch.Tensor:
    # on a card bincount reads the bins' least and greatest value back
    with span("sync.props_bincount"):
        return torch.bincount(bins.reshape(-1), minlength=n)


def _moment_tables(lab: torch.Tensor, K: int, with_bbox: bool):
    """Tables of labels 0..K-1 for (T, H, W) int64 labels, padded to 256."""
    T, H, W = lab.shape
    dev = lab.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    t = torch.arange(T, device=dev)[:, None, None]
    row_counts = _counts((t * H + ys[None, :, None]) * K + lab, T * H * K).reshape(T, H, K)
    col_counts = _counts((t * W + xs[None, None, :]) * K + lab, T * W * K).reshape(T, W, K)
    area = row_counts.sum(dim=1)
    sum_y = (row_counts * ys[None, :, None]).sum(dim=1)
    sum_x = (col_counts * xs[None, :, None]).sum(dim=1)
    valid = (area > 0) & (torch.arange(K, device=dev) != 0)[None, :]
    zero = torch.zeros_like(area)
    if with_bbox:
        big = 1 << 20
        row_has, col_has = row_counts > 0, col_counts > 0
        yy = ys[None, :, None].expand_as(row_counts)
        xx = xs[None, :, None].expand_as(col_counts)
        min_y = torch.where(row_has, yy, big).amin(dim=1)
        max_y = torch.where(row_has, yy, -1).amax(dim=1) + 1
        min_x = torch.where(col_has, xx, big).amin(dim=1)
        max_x = torch.where(col_has, xx, -1).amax(dim=1) + 1
    else:
        min_y = min_x = max_y = max_x = zero
    fields = {
        "area": area, "sum_y": sum_y, "sum_x": sum_x,
        "min_y": min_y, "min_x": min_x, "max_y": max_y, "max_x": max_x,
    }
    pad = MAX_LABELS - K

    def finish(a):
        a = torch.where(valid, a, zero).to(torch.int32)
        return torch.nn.functional.pad(a, (0, pad)) if pad else a

    out = {k: finish(v) for k, v in fields.items()}
    out["valid"] = torch.nn.functional.pad(valid, (0, pad)) if pad else valid
    return out


def region_tables(labels_u8: torch.Tensor, with_bbox: bool = True) -> RegionTable:
    """RegionTable of a (..., H, W) uint8 label batch.

    with_bbox=False leaves the bbox fields zero (tracking and events use
    centroids only)."""
    *lead, H, W = labels_u8.shape
    lab = labels_u8.reshape(-1, H, W).to(torch.int64)
    with span("sync.props_max"):
        fits = lab.numel() == 0 or int(lab.max()) < FAST_LABELS
    parts = _moment_tables(lab, FAST_LABELS if fits else MAX_LABELS, with_bbox)
    return RegionTable(**parts).map(lambda a: a.reshape(*lead, MAX_LABELS))
