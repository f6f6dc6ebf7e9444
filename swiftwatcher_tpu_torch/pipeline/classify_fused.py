"""Classify-then-track in one queued sequence on the device tracker.

Counterpart of swiftwatcher_tpu/pipeline/classify_fused.py, where it is one
jitted program.  Here it is one upload and one run of device work with no
host wait between the upload and the tracking scan:

    one pinned, non-blocking upload of the u8 canvases and the (4, P) int32
    meta (hs, ws, flat slot, drop) -> coefficient gather -> PIL-exact resize
    -> pad/normalize -> SqueezeNet -> argmax -> keep-mask scattered into
    the compacted valid slots -> kvalid AND -> the tracking scan (T1)

and only the event buffer (with the kept count beside it) is read back.
The results equal the unfused path's: each keep bit lands on the compacted
slot its crop came from, a degenerate (empty-slice) crop keeps its row
with drop=1 (the unfused path's keep=False), and padding rows carry the
out-of-range slot B*T*K, whose scatter lands in a spare element that is
cut off (JAX's mode="drop").

Reference anchor: segment_classification.py:26-44 (classify each segment,
keep label == 1, then track the survivors).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..models.classifier import classify_canvases, upload
from ..models.preprocess import pack_canvases
from .tracking_device import EventBuffer, TrackState, track_window


def classify_track_fused(
    params,
    coeff_table: torch.Tensor,  # (mx, out, mx) f64 PIL tap-weight table
    canv: np.ndarray,           # (P, mx, mx, 3) u8 zero-padded crop canvases
    meta: np.ndarray,           # (4, P) i32: hs, ws, flat slot, drop flag
    state: TrackState,
    roi_mask: torch.Tensor,
    cy: torch.Tensor,           # (B, T, K) f32 compacted centroids
    cx: torch.Tensor,
    kvalid: torch.Tensor,       # (B, T, K) bool, already null-frame gated
    fns: torch.Tensor,          # (B*T,) i32
    active: torch.Tensor,       # (B*T,) bool
    cfg: PipelineConfig = DEFAULT_CONFIG,
) -> Tuple[TrackState, EventBuffer, torch.Tensor]:
    """Classify every crop, AND the keep-mask into the compacted valid
    slots and run the tracking scan, all queued on kvalid's device.

    Returns (new state, event buffer, n_kept): n_kept is a 0-d device
    tensor, the number of real crops the network kept (the unfused path's
    segments_total increment), read back with the events."""
    canv_d, meta_d = upload([canv, meta], kvalid.device)
    hs, ws, slot, drop = meta_d.unbind(0)
    pred = classify_canvases(params, canv_d, coeff_table, hs, ws, cfg)
    keep_flat = (pred == 1) & (drop == 0)
    B, T, K = kvalid.shape
    n = B * T * K
    keep = torch.ones(n + 1, dtype=torch.bool, device=kvalid.device)
    keep.scatter_(0, slot.to(torch.int64), keep_flat)
    kvalid = kvalid & keep[:n].view(B, T, K)
    n_kept = (keep_flat & (slot < n)).sum()
    state, events = track_window(
        state, roi_mask, cy.reshape(B * T, K), cx.reshape(B * T, K),
        kvalid.reshape(B * T, K), fns, cfg, active=active)
    return state, events, n_kept


def pack_fused(segment_filter, view, frames: dict, crop_region, timers=None,
               ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Host half: every valid slot's crop, packed into canvases, and the
    (4, P) int32 meta plane (hs, ws, flat slot index, drop flag).

    view: the runner's _CompactTableView over the compacted (B, T, K)
    read-back.  frames: {(b, t): full-resolution BGR frame} for frames
    with a valid slot, as batch_call takes.  Returns (canv, meta, mx), or
    None when there is no crop or a crop fits no device canvas (the caller
    then takes the unfused path, as classify_images takes host PIL)."""
    t0 = time.perf_counter()
    B, T, K = view.valid.shape
    images, slots, drops = [], [], []
    for key in sorted(frames.keys()):
        b, t = key
        imgs, degenerate = segment_filter._frame_images(view, key, frames[key], crop_region)
        ks = np.nonzero(view.valid[b, t])[0]
        for k, img, is_degen in zip(ks, imgs, degenerate):
            slots.append((b * T + t) * K + int(k))
            drops.append(1 if is_degen else 0)
            # a degenerate crop keeps its row so slot and drop stay
            # positional; a 1x1 zero canvas is the cheapest placeholder
            images.append(np.zeros((1, 1, 3), np.uint8) if is_degen else img)
    if timers is not None:
        timers["classify_crop"] = timers.get("classify_crop", 0.0) + (
            time.perf_counter() - t0)
    if not images:
        return None
    t1 = time.perf_counter()
    mx = segment_filter._canvas_bucket(images)
    if mx == 0:
        return None
    n = len(images)
    padded_n = segment_filter._padded_n(n)
    canv, hs, ws = pack_canvases(images, mx)
    slot = np.asarray(slots, np.int32)
    drop = np.asarray(drops, np.int32)
    if padded_n != n:
        pad = padded_n - n
        canv = np.concatenate([canv, np.zeros((pad, mx, mx, 3), np.uint8)])
        # size-1 padding keeps the coefficient normalizer from 0/0; the
        # out-of-range slot sends the row's keep bit to the spare element
        hs = np.concatenate([hs, np.ones(pad, np.int32)])
        ws = np.concatenate([ws, np.ones(pad, np.int32)])
        slot = np.concatenate([slot, np.full(pad, B * T * K, np.int32)])
        drop = np.concatenate([drop, np.ones(pad, np.int32)])
    meta = np.stack([hs, ws, slot, drop])
    segment_filter.upload_bytes += canv.nbytes + meta.nbytes
    if timers is not None:
        timers["classify_pack"] = timers.get("classify_pack", 0.0) + (
            time.perf_counter() - t1)
    return canv, meta, mx
