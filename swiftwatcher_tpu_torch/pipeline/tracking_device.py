"""On-device tracking: the per-batch tracking scan.

Counterpart of swiftwatcher_tpu/pipeline/tracking_jax.py.  The host
tracker (tracking.py) is the strict-parity path; this one keeps the whole
loop on the device (per-frame padded cost matrices, the LAP, track linking,
ROI event tests), so a batch costs one launch and one read-back of its
event buffer instead of a host round trip per frame.

Cost-matrix layout over fixed capacity K = cfg.max_tracks (2K x 2K):
  row/col i < K = previous-frame slot i, row/col K+c = current slot c;
  diag(i, i) = nonmatch_cost for valid slots, 0 for padding slots;
  match cell (p, K+c) = 0.5 * 2^(dist-25) + 0.5 * 2^(angle_diff-90);
  every other valid-valid cell = nonmatch_cost + f32 epsilon (the
  reference's "impossible" filler); valid-vs-padding cells = _BIG.
Exponents are clamped at cfg.cost_exp_clamp.

On a CUDA tensor `track_window` launches csrc/track_scan.cu: the scan of
one batch in one launch, one block that keeps the state, the match block
and the LAP's duals in shared memory.  On a CPU tensor it runs
`track_window_reference`, the plain per-frame loop, which is also what the
kernel is held against on the card.

cfg.track_scan_chunk and cfg.track_stacked_ops are accepted and change
nothing: they reorganise the JAX scan for the TPU, and its outputs are
identical for any value of either (tests/test_tracking_jax.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .. import build
from ..config import DEFAULT_CONFIG, PipelineConfig
from ..ops.hungarian import solve_lap

# The reference adds float64 epsilon to 1.0; in float32 that rounds back to
# 1.0, losing "filler > diagonal", so the device tracker uses f32 epsilon.
_EPS32 = float(np.float32(1.1920929e-07))
_BIG = float(np.float32(1e9))

# The largest max_tracks the kernel takes (one thread per column of the
# 2K x 2K cost matrix, at most 128 threads).
MAX_KERNEL_TRACKS = 64


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass
class TrackState:
    cy: torch.Tensor          # (K,) f32 previous-frame centroids
    cx: torch.Tensor
    valid: torch.Tensor       # (K,) bool
    hist_len: torch.Tensor    # (K,) int32
    first_cy: torch.Tensor    # (K,) f32 first centroid of the motion path
    first_cx: torch.Tensor
    fn: torch.Tensor          # () int32 previous frame number

    _DTYPES = {"cy": np.float32, "cx": np.float32, "valid": bool, "hist_len": np.int32,
               "first_cy": np.float32, "first_cx": np.float32, "fn": np.int32}

    def to_numpy(self) -> dict:
        """{field: numpy array} (the JAX package's field names)."""
        return {f.name: getattr(self, f.name).cpu().numpy() for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, arrays, device=torch.device("cpu")) -> "TrackState":
        """From a {field: array} mapping, or any object with the fields as
        attributes (such as the JAX package's TrackState)."""
        get = arrays.__getitem__ if isinstance(arrays, Mapping) else functools.partial(
            getattr, arrays)
        return cls(**{
            name: torch.from_numpy(np.array(get(name), dtype=dt)).to(device)
            for name, dt in cls._DTYPES.items()
        })


@dataclasses.dataclass
class EventBuffer:
    first_cy: torch.Tensor    # (CAP,) f32
    first_cx: torch.Tensor
    last_cy: torch.Tensor
    last_cx: torch.Tensor
    last_fn: torch.Tensor     # (CAP,) int32
    count: torch.Tensor       # () int32
    overflow: torch.Tensor    # () bool

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy() for f in dataclasses.fields(self)}


# Every tensor below is made on the device by a fill, never copied from the
# host: a copy from pageable memory would make the host wait for the stream.
def empty_state(K: int, device=torch.device("cpu")) -> TrackState:
    z = torch.zeros(K, dtype=torch.float32, device=device)
    return TrackState(
        cy=z, cx=z.clone(), valid=torch.zeros(K, dtype=torch.bool, device=device),
        hist_len=torch.zeros(K, dtype=torch.int32, device=device),
        first_cy=z.clone(), first_cx=z.clone(),
        fn=torch.full((), -1, dtype=torch.int32, device=device),
    )


def empty_events(cap: int, device=torch.device("cpu")) -> EventBuffer:
    def z(dtype):
        return torch.zeros(cap, dtype=dtype, device=device)

    return EventBuffer(
        first_cy=z(torch.float32), first_cx=z(torch.float32),
        last_cy=z(torch.float32), last_cx=z(torch.float32), last_fn=z(torch.int32),
        count=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass(frozen=True)
class _Consts:
    """The config's tracker constants as f32 values (each exact in f32, so
    every product or sum with one rounds once, as in the JAX version)."""

    dist_knee: float
    angle_knee: float
    clamp: float
    nonmatch: float
    filler: float             # nonmatch + eps, rounded to f32
    w_offset: float           # eps - nonmatch, rounded to f32
    deg: float = _f32(180.0 / np.pi)


def _consts(cfg: PipelineConfig) -> _Consts:
    nonmatch = np.float32(cfg.nonmatch_cost)
    return _Consts(
        dist_knee=_f32(cfg.dist_cost_knee), angle_knee=_f32(cfg.angle_cost_knee),
        clamp=_f32(cfg.cost_exp_clamp), nonmatch=float(nonmatch),
        filler=float(nonmatch + np.float32(_EPS32)),
        w_offset=float(np.float32(_EPS32) - nonmatch),
    )


def _match_block(state: TrackState, cy, cx, cfg: PipelineConfig) -> torch.Tensor:
    """(K, K) f32 match costs 0.5*d_cost + 0.5*a_cost for every (prev slot,
    curr slot) pair, validity-agnostic (callers mask)."""
    c = _consts(cfg)
    dy = state.cy[:, None] - cy[None, :]
    dx = state.cx[:, None] - cx[None, :]
    d = torch.sqrt(dy * dy + dx * dx)
    d_cost = torch.exp2(torch.clamp_max(d - c.dist_knee, c.clamp))
    old_angle = c.deg * torch.atan2(state.first_cy - state.cy, -(state.first_cx - state.cx))
    new_angle = c.deg * torch.atan2(dy, -dx)
    diff = (new_angle - old_angle[:, None]).abs()
    diff = torch.minimum(diff, 360.0 - diff)
    a_cost = torch.where(
        (state.hist_len > 0)[:, None],
        torch.exp2(torch.clamp_max(diff - c.angle_knee, c.clamp)),
        1.0,
    )
    return 0.5 * d_cost + 0.5 * a_cost


def _cost_matrix(state: TrackState, cy, cx, valid, cfg: PipelineConfig) -> torch.Tensor:
    K = state.cy.shape[0]
    c = _consts(cfg)
    match = _match_block(state, cy, cx, cfg)
    rv = torch.cat([state.valid, valid])                 # row validity (2K,)
    both_valid = rv[:, None] & rv[None, :]
    cost = torch.full((2 * K, 2 * K), _BIG, dtype=torch.float32, device=cy.device)
    cost[both_valid] = c.filler
    cost[:K, K:] = torch.where(both_valid[:K, K:], match, _BIG)
    # diagonal: non-match cost for valid slots, free parking for padding
    cost.diagonal().copy_(torch.where(rv, c.nonmatch, 0.0))
    return cost


@functools.lru_cache(maxsize=None)
def _pattern_table(n: int) -> np.ndarray:
    """All partial matchings of n rows onto n columns, as (num_patterns, n)
    int32 rows of matched-column-or-(-1), in the JAX package's order.
    Sizes: n=3 -> 34, 4 -> 209, 5 -> 1546, 6 -> 13327; larger n is
    rejected (the table would dwarf the LAP it replaces)."""
    if n > 6:
        raise ValueError(f"enum LAP pattern table capped at n=6 (got {n})")
    pats: list[list[int]] = []

    def rec(row: int, used: int, cur: list[int]) -> None:
        if row == n:
            pats.append(cur)
            return
        rec(row + 1, used, cur + [-1])
        for col in range(n):
            if not (used >> col) & 1:
                rec(row + 1, used | (1 << col), cur + [col])

    rec(0, 0, [])
    return np.asarray(pats, np.int32)


def _prev_match_lap(state: TrackState, cy, cx, valid, cfg: PipelineConfig) -> torch.Tensor:
    """(K,) int32: current slot matched to each previous slot (-1 if
    unmatched), by the full padded JV solve, padding rows pre-assigned."""
    K = state.cy.shape[0]
    cost = _cost_matrix(state, cy, cx, valid, cfg)
    col4row = solve_lap(cost, skip=~torch.cat([state.valid, valid]))
    match_col = col4row[:K] - K
    ok = state.valid & (match_col >= 0) & valid[match_col.clamp(0, K - 1).long()]
    return torch.where(ok, match_col, -1).to(torch.int32)


def _prev_match_enum(state: TrackState, cy, cx, valid, cfg: PipelineConfig, n: int):
    """Enumeration LAP for frames whose live tracks and segments all lie in
    the first n slots: every partial matching of n rows is scored as the
    sum, over matched (p, c) in row-major order, of m(p, c) + eps -
    nonmatch (_BIG for an invalid pair), and the first least score wins
    (tracking_jax.py:_prev_match_enum)."""
    K = state.cy.shape[0]
    sub = TrackState(
        cy=state.cy[:n], cx=state.cx[:n], valid=state.valid[:n],
        hist_len=state.hist_len[:n], first_cy=state.first_cy[:n],
        first_cx=state.first_cx[:n], fn=state.fn,
    )
    w = _match_block(sub, cy[:n], cx[:n], cfg) + _consts(cfg).w_offset
    w = torch.where(sub.valid[:, None] & valid[None, :n], w, _BIG)
    pat = torch.from_numpy(_pattern_table(n)).to(cy.device)           # (P, n)
    rows = torch.arange(n, device=cy.device)[None, :]
    terms = torch.where(pat >= 0, w[rows, pat.clamp(min=0).long()], 0.0)
    scores = torch.zeros(pat.shape[0], dtype=torch.float32, device=cy.device)
    for p in range(n):
        scores = scores + terms[:, p]
    best = int(torch.argmin(scores))
    return torch.cat([pat[best], torch.full((K - n,), -1, dtype=torch.int32, device=cy.device)])


def _step_full(state: TrackState, events: EventBuffer, cy, cx, valid, fn, roi_mask,
               cfg: PipelineConfig) -> TrackState:
    """One frame with work: match, append this frame's events to `events`
    (in place) and return the new state."""
    K = state.cy.shape[0]
    n_enum = int(cfg.track_enum_lap)
    if 0 < n_enum < K and not bool(state.valid[n_enum:].any() | valid[n_enum:].any()):
        prev_match = _prev_match_enum(state, cy, cx, valid, cfg, n_enum)
    else:
        prev_match = _prev_match_lap(state, cy, cx, valid, cfg)
    disappeared = state.valid & (prev_match < 0)

    # events: disappeared inside the ROI with history
    Hm, Wm = roi_mask.shape
    iy = state.cy.to(torch.int32).clamp(0, Hm - 1)
    ix = state.cx.to(torch.int32).clamp(0, Wm - 1)
    in_roi = roi_mask.reshape(-1)[(iy * Wm + ix).long()] == 255
    is_event = disappeared & in_roi & (state.hist_len >= 1)
    cap = events.first_cy.shape[0]
    # event slot k lands at count + its rank among events in ascending slot
    # order; slots at or past the cap are dropped
    n_ev = is_event.sum().to(torch.int32)
    pos = events.count + torch.cumsum(is_event, 0) - 1
    write = is_event & (pos < cap)
    slot = pos[write].long()
    hist_pos = state.hist_len > 0
    events.first_cy[slot] = torch.where(hist_pos, state.first_cy, state.cy)[write]
    events.first_cx[slot] = torch.where(hist_pos, state.first_cx, state.cx)[write]
    events.last_cy[slot] = state.cy[write]
    events.last_cx[slot] = state.cx[write]
    events.last_fn[slot] = state.fn
    events.overflow |= events.count + n_ev > cap
    events.count.copy_(torch.clamp_max(events.count + n_ev, cap))

    # link: the new state from the current segments
    curr_from = torch.full((K + 1,), -1, dtype=torch.int32, device=cy.device)
    matched = prev_match >= 0
    curr_from[prev_match[matched].long()] = torch.arange(
        K, dtype=torch.int32, device=cy.device)[matched]
    curr_from = curr_from[:K]
    linked = (curr_from >= 0) & valid
    p = curr_from.clamp(0, K - 1).long()
    hist_p = state.hist_len[p]
    pf_cy = torch.where(hist_p > 0, state.first_cy[p], state.cy[p])
    pf_cx = torch.where(hist_p > 0, state.first_cx[p], state.cx[p])
    return TrackState(
        cy=cy.clone(), cx=cx.clone(), valid=valid.clone(),
        hist_len=torch.where(linked, hist_p + 1, 0).to(torch.int32),
        first_cy=torch.where(linked, pf_cy, 0.0),
        first_cx=torch.where(linked, pf_cx, 0.0),
        fn=fn.clone(),
    )


def _step(state: TrackState, events: EventBuffer, cy, cx, valid, fn, roi_mask,
          cfg: PipelineConfig) -> TrackState:
    """One active frame.  With no live track and no segment the full step
    reduces to 'reset the state to this frame', which this does directly."""
    if bool(state.valid.any() | valid.any()):
        return _step_full(state, events, cy, cx, valid, fn, roi_mask, cfg)
    zero = torch.zeros_like(state.first_cy)
    return TrackState(
        cy=cy.clone(), cx=cx.clone(), valid=valid.clone(),
        hist_len=torch.zeros_like(state.hist_len), first_cy=zero, first_cx=zero.clone(),
        fn=fn.clone(),
    )


def track_window_reference(
    state: TrackState,
    roi_mask: torch.Tensor,
    cys: torch.Tensor,        # (T, K) f32
    cxs: torch.Tensor,
    valids: torch.Tensor,     # (T, K) bool
    fns: torch.Tensor,        # (T,) int32
    cfg: PipelineConfig = DEFAULT_CONFIG,
    active: Optional[torch.Tensor] = None,   # (T,) bool; False = no-op frame
) -> Tuple[TrackState, EventBuffer]:
    """Plain PyTorch version of the scan: `_step` frame by frame; inactive
    frames change nothing.  The event buffer holds 4 * T events."""
    T = cys.shape[0]
    events = empty_events(4 * T, cys.device)
    act = [True] * T if active is None else active.tolist()
    fns = fns.to(torch.int32)
    for t in range(T):
        if act[t]:
            state = _step(state, events, cys[t], cxs[t], valids[t], fns[t], roi_mask, cfg)
    return state, events


@functools.lru_cache(maxsize=None)
def _device_patterns(n: int, device: torch.device) -> torch.Tensor:
    """_pattern_table(n) on `device`, one int32 per pattern: row p's column
    in bits 3p..3p+2, 7 where the row is unmatched."""
    pats = _pattern_table(n)
    cols = np.where(pats >= 0, pats, 7).astype(np.int64)
    return torch.from_numpy((cols << (3 * np.arange(n))).sum(axis=1).astype(np.int32)).to(device)


def track_window(
    state: TrackState,
    roi_mask: torch.Tensor,
    cys: torch.Tensor,
    cxs: torch.Tensor,
    valids: torch.Tensor,
    fns: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    active: Optional[torch.Tensor] = None,
) -> Tuple[TrackState, EventBuffer]:
    """Scan the tracker over T frames of compacted (T, K) segment tables:
    (new state, event buffer of 4 * T events).  CPU tensors take
    `track_window_reference`; CUDA tensors launch csrc/track_scan.cu."""
    if cys.device.type == "cpu":
        return track_window_reference(state, roi_mask, cys, cxs, valids, fns, cfg, active)
    dev = cys.device
    T, K = cys.shape
    if K > MAX_KERNEL_TRACKS:
        raise ValueError(f"track_window: max_tracks {K} exceeds the kernel's "
                         f"{MAX_KERNEL_TRACKS}")
    if active is None:
        active = torch.ones(T, dtype=torch.bool, device=dev)
    operands = (
        ("cys", cys, torch.float32, (T, K)), ("cxs", cxs, torch.float32, (T, K)),
        ("valids", valids, torch.bool, (T, K)), ("fns", fns, torch.int32, (T,)),
        ("active", active, torch.bool, (T,)), ("roi_mask", roi_mask, torch.uint8, None),
        *((f"state.{f.name}", getattr(state, f.name), dt, (K,) if f.name != "fn" else ())
          for f, dt in zip(dataclasses.fields(state), (
              torch.float32, torch.float32, torch.bool, torch.int32, torch.float32,
              torch.float32, torch.int32))),
    )
    for what, t, dtype, shape in operands:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"track_window: {what} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on {dev}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if roi_mask.dim() != 2:
        raise ValueError(f"track_window: roi_mask must be (H, W), got {tuple(roi_mask.shape)}")
    n_enum = int(cfg.track_enum_lap)
    if 0 < n_enum < K:
        pats = _device_patterns(n_enum, dev)
    else:
        n_enum, pats = 0, torch.zeros(1, dtype=torch.int32, device=dev)
    c = _consts(cfg)
    out = empty_state(K, dev)
    events = empty_events(4 * T, dev)
    Hm, Wm = roi_mask.shape
    build.launch(
        "track_scan", "swt_track_scan", dev,
        *(getattr(state, f.name).data_ptr() for f in dataclasses.fields(state)),
        roi_mask.data_ptr(), Hm, Wm,
        cys.data_ptr(), cxs.data_ptr(), valids.data_ptr(), fns.data_ptr(),
        active.data_ptr(), T, K,
        pats.data_ptr(), pats.shape[0] if n_enum else 0, n_enum,
        c.dist_knee, c.angle_knee, c.clamp, c.deg, c.nonmatch, c.filler, c.w_offset, _BIG,
        *(getattr(out, f.name).data_ptr() for f in dataclasses.fields(out)),
        *(getattr(events, f.name).data_ptr() for f in dataclasses.fields(events)),
        4 * T,
    )
    track_window.launches += 1
    return out, events


track_window.launches = 0


def compact_tables(table, K: int, with_bbox: bool = False):
    """RegionTable (..., 256) -> the first K valid slots in ascending label
    order: (cys, cxs, valids, overflow) of shapes (..., K), (..., K), (..., K)
    and (...).  with_bbox also returns (min_y, min_x, max_y, max_x) gathered
    in the same order, so a slot's crop lines up with its keep bit (the
    classifier reads these back instead of the 256-slot table).

    The valid-first stable order is a cumsum-rank scatter: valid slot i
    lands at rank(valid)_i - 1, invalid slot i at n_valid + rank(invalid)_i
    - 1, which is stable argsort(~valid)'s placement."""
    valid = table.valid
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    nv = torch.cumsum(valid.to(torch.int64), dim=-1)
    n_valid = nv[..., -1:]
    pos = torch.where(valid, nv - 1, n_valid + (idx - nv))
    order_full = torch.zeros_like(pos).scatter_(-1, pos, idx.expand_as(pos).clone())
    order = order_full[..., :K]

    def take(a):
        return torch.gather(a, -1, order)

    area = take(table.area).clamp_min(1).to(torch.float32)
    cy = take(table.sum_y).to(torch.float32) / area
    cx = take(table.sum_x).to(torch.float32) / area
    out = (cy, cx, take(valid), valid.sum(dim=-1) > K)
    if with_bbox:
        return out + (tuple(take(a) for a in (table.min_y, table.min_x, table.max_y,
                                              table.max_x)),)
    return out
