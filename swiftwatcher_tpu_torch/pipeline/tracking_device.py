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

On a CUDA tensor `track_window` launches csrc/track_scan.cu's two kernels
(one call, no host wait).  T1a, one block a frame, writes each frame's
chain-free pieces: the state's positions and validity at that frame (the
slots of the last active frame before it), the K x K distance terms and
current angles of the match block, the previous slots' ROI flags, the
frame's kind and the next frame with work (`track_prologue`; its plain
version `track_prologue_reference`).  T1b, one warp, walks the frames
with work only, the matching's histories being all that the chain
carries.  On a CPU tensor it runs `track_window_reference`, the plain
per-frame loop, which is also what the kernels are held against on the
card.

cfg.track_scan_chunk and cfg.track_stacked_ops are accepted and change
nothing: they reorganise the JAX scan for the TPU, and its outputs are
identical for any value of either (tests/test_tracking_jax.py).  T1b
skips every stretch of empty frames exactly, which is what a chunk of the
JAX scan does when its chunk is empty.
"""

from __future__ import annotations

import ctypes
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

# The largest max_tracks the kernels take (T1b's lane owns at most 4
# columns of the 2K x 2K cost matrix and 2 slots).
MAX_KERNEL_TRACKS = 64

# Frame kinds (Prologue.kind).
INACTIVE, EMPTY, ENUMERATION, JV = 0, 1, 2, 3


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


def _pair_terms(prev_cy, prev_cx, cy, cx, c: _Consts):
    """The chain-free terms of the match block for previous slots (rows)
    and current slots (columns): the distance term 2^min(dist - knee,
    clamp) and the current angle deg * atan2(dy, -dx)."""
    dy = prev_cy[:, None] - cy[None, :]
    dx = prev_cx[:, None] - cx[None, :]
    d = torch.sqrt(dy * dy + dx * dx)
    d_cost = torch.exp2(torch.clamp_max(d - c.dist_knee, c.clamp))
    return d_cost, c.deg * torch.atan2(dy, -dx)


def _assemble(d_cost, new_angle, state: TrackState, c: _Consts) -> torch.Tensor:
    """The match block from its chain-free terms and the rows' histories:
    0.5 * d_cost + 0.5 * a_cost, a_cost the angle term of rows with history
    (1 for the others)."""
    old_angle = c.deg * torch.atan2(state.first_cy - state.cy, -(state.first_cx - state.cx))
    diff = (new_angle - old_angle[:, None]).abs()
    diff = torch.minimum(diff, 360.0 - diff)
    a_cost = torch.where(
        (state.hist_len > 0)[:, None],
        torch.exp2(torch.clamp_max(diff - c.angle_knee, c.clamp)),
        1.0,
    )
    return 0.5 * d_cost + 0.5 * a_cost


def _match_block(state: TrackState, cy, cx, cfg: PipelineConfig) -> torch.Tensor:
    """(K, K) f32 match costs 0.5*d_cost + 0.5*a_cost for every (prev slot,
    curr slot) pair, validity-agnostic (callers mask)."""
    c = _consts(cfg)
    return _assemble(*_pair_terms(state.cy, state.cx, cy, cx, c), state, c)


def _in_roi(cy, cx, roi_mask) -> torch.Tensor:
    """(K,) bool: each centroid's ROI-mask pixel is 255 (coordinates
    truncated and clamped to the mask)."""
    Hm, Wm = roi_mask.shape
    iy = cy.to(torch.int32).clamp(0, Hm - 1)
    ix = cx.to(torch.int32).clamp(0, Wm - 1)
    return roi_mask.reshape(-1)[(iy * Wm + ix).long()] == 255


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
    is_event = disappeared & _in_roi(state.cy, state.cx, roi_mask) & (state.hist_len >= 1)
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
    in bits 3p..3p+2, 7 where the row is unmatched; padded to a multiple of
    32 with patterns whose row 0 takes column 6, which T1b scores +inf."""
    pats = _pattern_table(n)
    cols = np.where(pats >= 0, pats, 7).astype(np.int64)
    codes = (cols << (3 * np.arange(n))).sum(axis=1)
    codes = np.concatenate([codes, np.full(-len(codes) % 32, 6, np.int64)])
    return torch.from_numpy(codes.astype(np.int32)).to(device)


def _prev_frames(cys, active):
    """(T,) int64: the last active frame before each frame, -1 if none."""
    T = cys.shape[0]
    idx = torch.arange(T, device=cys.device)
    last = torch.cummax(torch.where(active, idx, -1), 0).values
    return torch.cat([last.new_full((1,), -1), last[:-1]])


@dataclasses.dataclass
class Prologue:
    """Each frame's chain-free pieces (T1a's output; `track_prologue`)."""

    prev_cy: torch.Tensor     # (T, K) f32: the state's centroids at frame t
    prev_cx: torch.Tensor
    prev_valid: torch.Tensor  # (T, K) bool: the state's validity at frame t
    prev_fn: torch.Tensor     # (T,) int32: the state's frame number at frame t
    valid: torch.Tensor       # (T, K) bool: the frame's own slots
    dist: torch.Tensor        # (T, K, K) f32: 2^min(dist - knee, clamp), (prev, curr)
    angle: torch.Tensor       # (T, K, K) f32: deg * atan2(dy, -dx), (prev, curr)
    roi: torch.Tensor         # (T, K) bool: the previous slot lies in the ROI
    kind: torch.Tensor        # (T,) int32: INACTIVE, EMPTY, ENUMERATION or JV
    next: torch.Tensor        # (T,) int32: the first frame after t with work, T if none
    src: torch.Tensor         # (T,) int32: the last active frame before t, -1 if none
    last_active: torch.Tensor  # () int32: the batch's last active frame, -1 if none

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy() for f in dataclasses.fields(self)}


def track_prologue_reference(state: TrackState, roi_mask, cys, cxs, valids, fns,
                             cfg: PipelineConfig = DEFAULT_CONFIG,
                             active: Optional[torch.Tensor] = None) -> Prologue:
    """Plain PyTorch version of T1a.  The state's positions, validity and
    frame number at frame t are those of the last active frame before t
    (linking and the empty-frame reset both copy the frame's slots; the
    incoming state before the first).  A frame has work (ENUMERATION or
    JV) if it is active and it or that state has a valid slot; it fits the
    enumeration if all of those slots lie below cfg.track_enum_lap.  The
    planes are `_pair_terms` of each frame, as `_match_block` computes
    them."""
    T, K = cys.shape
    dev = cys.device
    act = torch.ones(T, dtype=torch.bool, device=dev) if active is None else active.bool()
    src = _prev_frames(cys, act)
    has = (src >= 0)[:, None]
    at = src.clamp(min=0)
    prev_cy = torch.where(has, cys[at], state.cy[None, :])
    prev_cx = torch.where(has, cxs[at], state.cx[None, :])
    prev_valid = torch.where(has, valids[at], state.valid[None, :])
    prev_fn = torch.where(src >= 0, fns.to(torch.int32)[at], state.fn).to(torch.int32)
    c = _consts(cfg)
    terms = [_pair_terms(prev_cy[t], prev_cx[t], cys[t], cxs[t], c) for t in range(T)]
    empty = torch.zeros((0, K, K), dtype=torch.float32, device=dev)
    dist = torch.stack([d for d, _ in terms]) if T else empty
    angle = torch.stack([a for _, a in terms]) if T else empty
    n = int(cfg.track_enum_lap)
    live = prev_valid | valids
    fits = ~live[:, n:].any(1) if 0 < n < K else torch.zeros_like(act)
    kind = torch.where(~act, INACTIVE, torch.where(
        ~live.any(1), EMPTY, torch.where(fits, ENUMERATION, JV))).to(torch.int32)
    idx = torch.arange(T, device=dev)
    first_from = torch.flip(torch.cummin(torch.flip(
        torch.where(kind >= ENUMERATION, idx, T), [0]), 0).values, [0])
    nxt = torch.cat([first_from[1:], first_from.new_full((1,), T)])[:T]
    last = torch.where(act, idx, -1).max() if T else torch.tensor(-1, device=dev)
    return Prologue(
        prev_cy=prev_cy, prev_cx=prev_cx, prev_valid=prev_valid, prev_fn=prev_fn,
        valid=valids.clone(), dist=dist, angle=angle, roi=_in_roi(prev_cy, prev_cx, roi_mask),
        kind=kind, next=nxt.to(torch.int32), src=src.to(torch.int32),
        last_active=last.to(torch.int32))


def _record_words(K: int) -> int:
    """Words of one frame's record in T1a's output (csrc/track_scan.cu:
    RecordLayout): an 8-word header (kind, next, src, prev_fn, the previous
    and the frame's validity as 64-bit masks), prev_cy, prev_cx, K ROI
    bytes, the distance terms and the angles, padded to 4 words."""
    return (8 + 2 * K + (K + 3) // 4 + 2 * K * K + 3) // 4 * 4


def _unpack_records(records: torch.Tensor, T: int, K: int) -> Prologue:
    """T1a's records as a Prologue (views where the layout allows)."""
    rec = records[: T * _record_words(K)].view(T, -1)
    flt = rec.view(torch.float32)
    k = torch.arange(K, device=rec.device)

    def mask(at: int):
        words = rec[:, at:at + 2][:, k // 32]
        return ((words >> (k % 32)) & 1).bool()

    roi0, d0 = 8 + 2 * K, 8 + 2 * K + (K + 3) // 4
    return Prologue(
        prev_cy=flt[:, 8:8 + K], prev_cx=flt[:, 8 + K:8 + 2 * K], prev_valid=mask(4),
        prev_fn=rec[:, 3], valid=mask(6),
        dist=flt[:, d0:d0 + K * K].reshape(T, K, K),
        angle=flt[:, d0 + K * K:d0 + 2 * K * K].reshape(T, K, K),
        roi=rec[:, roi0:d0].contiguous().view(torch.uint8)[:, :K].bool(),
        kind=rec[:, 0], next=rec[:, 1], src=rec[:, 2],
        last_active=records[T * _record_words(K)] if T else records.new_full((), -1))


# What T1 counts into its optional stats output (int64, one entry each):
# frames by kind, JV rows and Dijkstra steps, events; then, in a build
# with -DT1_SPLIT (tools/time_kernels.py --t1-split), T1b's SM cycles per
# phase and in all (0 otherwise).
STAT_NAMES = (
    "work frames", "enumeration frames", "JV frames", "JV rows", "Dijkstra steps",
    "empty frames", "inactive frames", "events",
    "cycles top", "cycles match", "cycles enumeration", "cycles JV steps", "cycles JV rows",
    "cycles events", "cycles link", "cycles total",
)


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
    `track_window_reference`; CUDA tensors launch csrc/track_scan.cu's T1a
    and T1b (counted as one launch of track_window; track_window.kernels
    counts the kernels the call launched)."""
    if cys.device.type == "cpu":
        return track_window_reference(state, roi_mask, cys, cxs, valids, fns, cfg, active)
    return scan_cuda(state, roi_mask, cys, cxs, valids, fns, cfg, active)


def track_prologue(state: TrackState, roi_mask, cys, cxs, valids, fns,
                   cfg: PipelineConfig = DEFAULT_CONFIG,
                   active: Optional[torch.Tensor] = None) -> Prologue:
    """T1a alone (CUDA tensors) or `track_prologue_reference` (CPU)."""
    if cys.device.type == "cpu":
        return track_prologue_reference(state, roi_mask, cys, cxs, valids, fns, cfg, active)
    records, _, _, _ = _launch(state, roi_mask, cys, cxs, valids, fns, cfg, active,
                               prologue_only=True)
    return _unpack_records(records, *cys.shape)


def scan_cuda(state, roi_mask, cys, cxs, valids, fns, cfg=DEFAULT_CONFIG, active=None,
              stats: Optional[torch.Tensor] = None, defines=()):
    """`track_window` on CUDA tensors; `stats`, a zeroed (len(STAT_NAMES),)
    int64 tensor on the card, receives T1's counts (STAT_NAMES), and
    `defines` select a build of the kernels (tools/time_kernels.py's split
    build: ("T1_SPLIT",))."""
    _, out, events, n_kernels = _launch(state, roi_mask, cys, cxs, valids, fns, cfg, active,
                                        stats=stats, defines=defines)
    track_window.launches += 1
    track_window.kernels += n_kernels
    return out, events


def _launch(state, roi_mask, cys, cxs, valids, fns, cfg, active, prologue_only=False,
            stats=None, defines=()):
    """Check the operands and launch T1a and (unless prologue_only) T1b:
    (T1a's records, the new state, the events, the number of kernels the
    launcher reports it launched)."""
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
        *((("stats", stats, torch.int64, (len(STAT_NAMES),)),) if stats is not None else ()),
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
    records = torch.empty(T * _record_words(K) + 4, dtype=torch.int32, device=dev)
    out = events = None
    if not prologue_only:
        out = empty_state(K, dev)
        events = empty_events(4 * T, dev)
    Hm, Wm = roi_mask.shape
    launched = ctypes.c_int(0)

    def ptrs(x):
        return (getattr(x, f.name).data_ptr() for f in dataclasses.fields(x)) if x else (0,) * 7

    build.launch(
        "track_scan", "swt_track_scan", dev,
        *(getattr(state, f.name).data_ptr() for f in dataclasses.fields(state)),
        roi_mask.data_ptr(), Hm, Wm,
        cys.data_ptr(), cxs.data_ptr(), valids.data_ptr(), fns.data_ptr(),
        active.data_ptr(), T, K,
        pats.data_ptr(), pats.shape[0] if n_enum else 0, n_enum,
        c.dist_knee, c.angle_knee, c.clamp, c.deg, c.nonmatch, c.filler, c.w_offset, _BIG,
        records.data_ptr(), int(prologue_only), *ptrs(out), *ptrs(events),
        4 * T, 0 if stats is None else stats.data_ptr(), ctypes.addressof(launched),
        defines=defines,
    )
    return records, out, events, launched.value


track_window.launches = 0
track_window.kernels = 0


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
