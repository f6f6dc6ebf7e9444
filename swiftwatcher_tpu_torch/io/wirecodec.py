"""Lossless host-to-device wire codec for gray window batches.

Counterpart of swiftwatcher_tpu/io/wirecodec.py.  The host encodes each
(N, H, W) u8 gray batch into a packet of fewer bytes; the device decodes it
back bit for bit before localisation (pipeline/window.py:
localize_windows_packed / _packed6).  Worth it only on a slow link:
io/prefetch.py's `auto` engages delta6 below cfg.wire_auto_mbps.

  delta4: residual r_t = (x_t - x_{t-1}) mod 256 over the flattened frame
    sequence; residuals in [-7, 7] become one nibble (value + 7, 0..14),
    the rest escape (nibble 15) and ship their mod-256 byte in a sparse
    (index, value) stream.  Frame 0 ships raw.
  delta6: a per-batch predictor (mode 0, the rounded per-pixel batch mean;
    mode 1, the previous frame), chosen by the escape bytes it costs;
    level 1 packs residuals in [-2, 2] as three base-6 digits a byte
    (digit 5 escapes), level 2 the escaped residuals in [-7, 7] as dense
    nibbles in stream order (15 escapes again), level 3 the rest as a
    sparse (flat index, byte) stream.

The encoders are numpy (or their threaded C twins in csrc/wire_encode.cpp,
io/native.py, where g++ built them: the same bytes), byte for byte the JAX
package's, and return None when the sparse stream overflows its cap; the
caller then ships the batch raw.  The decoders are torch ops on the
packet's device; the JAX decode is plain XLA with no Pallas kernel behind
it.  Every sum runs in int32 and is reduced mod 256 with `& 255` before the
cast to u8; the sparse streams are padded with an index one past the end,
which the decode scatters into a spare element and drops (torch's scatters
raise on an index out of range).  delta6's `mode` is a host integer on the
packet (the encoder knows it), so the decode never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import native

_NIB_BIAS = 7          # delta4 nibble = centered residual + 7, values 0..14
_NIB_ESCAPE = 15
_D6_BIAS = 2           # delta6 level-1 digit = residual + 2, values 0..4
_D6_ESCAPE = 5


@dataclasses.dataclass
class WirePacket:
    """A delta4 packet (numpy arrays on the host, tensors once uploaded)."""

    first: object      # (H, W) u8: frame 0, raw
    packed: object     # (ceil((N-1)*H*W / 2),) u8: two nibbles a byte
    esc_idx: object    # (cap,) int32 flat residual indices, padded with (N-1)*H*W
    esc_val: object    # (cap,) u8 mod-256 residual bytes
    shape: Tuple[int, int, int]  # (N, H, W) of the decoded batch

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(a) for a in (self.first, self.packed, self.esc_idx, self.esc_val))


@dataclasses.dataclass
class WirePacket6:
    """A delta6 packet (numpy arrays on the host, tensors once uploaded)."""

    mode: int          # 0 = batch-mean predictor, 1 = previous frame
    bg: object         # (H, W) u8 predictor base (the mean, or frame 0)
    lvl1: object       # (N, ceil(H*W / 3)) u8: three base-6 digits a byte
    lvl2: object       # (>= ceil(n1 / 2),) u8: two nibbles a byte, padded
    esc_idx: object    # (cap3,) int32 flat (N*H*W) indices, padded with N*H*W
    esc_val: object    # (cap3,) u8 mod-256 residual bytes
    shape: Tuple[int, int, int]  # (N, H, W) of the decoded batch

    @property
    def nbytes(self) -> int:
        # the mode ships as one byte, as the JAX package's () u8 array does
        return 1 + sum(_nbytes(a) for a in (self.bg, self.lvl1, self.lvl2, self.esc_idx,
                                             self.esc_val))


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def encode_delta4(gray: np.ndarray, escape_cap: int) -> Optional[WirePacket]:
    """Encode an (N, H, W) u8 stack; None with fewer than two frames or
    more than escape_cap escapes."""
    N, H, W = gray.shape
    if N < 2:
        return None
    flat = np.ascontiguousarray(gray.reshape(N, H * W))
    if native.has_symbol("swt_encode_delta4"):
        enc = native.encode_delta4(flat, escape_cap)
        if enc is None:
            return None
        packed, idx, val = enc
        return WirePacket(np.ascontiguousarray(gray[0]), packed, idx, val, (N, H, W))
    delta = flat[1:] - flat[:-1]                     # u8 wraparound
    # centered residual in [-7, 7] <=> (delta + 7) mod 256 in [0, 14]
    nib0 = delta + np.uint8(_NIB_BIAS)
    esc = nib0 > 14
    n_esc = int(np.count_nonzero(esc))
    if n_esc > escape_cap:
        return None
    flatn = np.minimum(nib0, np.uint8(_NIB_ESCAPE)).reshape(-1)
    M = flatn.size
    if M % 2:
        flatn = np.append(flatn, np.uint8(0))
    pairs = flatn.reshape(-1, 2)
    packed = pairs[:, 0] | (pairs[:, 1] << 4)
    idx = np.full(escape_cap, M, np.int32)           # M: one past the end, dropped
    val = np.zeros(escape_cap, np.uint8)
    if n_esc:
        where = np.flatnonzero(esc).astype(np.int32)
        idx[:n_esc] = where
        val[:n_esc] = delta.reshape(-1)[where]
    return WirePacket(np.ascontiguousarray(gray[0]), packed, idx, val, (N, H, W))


def _scatter_drop(r: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """r with r[idx] = val for every idx inside r; the padding (any index
    outside it) lands in a spare element that is dropped."""
    n = r.numel()
    buf = torch.empty(n + 1, dtype=torch.int32, device=r.device)
    buf[:n] = r
    i = idx.to(torch.int64)
    i = torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    buf.index_put_((i,), val.to(torch.int32))
    return buf[:n]


def decode_delta4(first: torch.Tensor, packed: torch.Tensor, esc_idx: torch.Tensor,
                  esc_val: torch.Tensor, N: int, H: int, W: int) -> torch.Tensor:
    """Inverse of encode_delta4 on the arrays' device -> (N, H, W) u8."""
    P = H * W
    M = (N - 1) * P
    p = packed.to(torch.int32)
    nib = torch.stack((p & 15, p >> 4), dim=-1).reshape(-1)[:M]
    res = torch.where(nib == _NIB_ESCAPE, torch.zeros_like(nib), nib - _NIB_BIAS)
    res = _scatter_drop(res, esc_idx, esc_val)
    csum = torch.cumsum(res.reshape(N - 1, P), dim=0, dtype=torch.int32)
    f0 = first.reshape(1, P).to(torch.int32)
    out = torch.cat((f0, (f0 + csum) & 255), dim=0)
    return out.to(torch.uint8).reshape(N, H, W)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on a card through a pinned copy, without
    waiting for the transfer."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_put_packet(pkt: WirePacket, device: torch.device) -> WirePacket:
    """Start the upload of a delta4 packet's arrays to `device`."""
    device = torch.device(device)
    return WirePacket(*(_upload(a, device) for a in (pkt.first, pkt.packed, pkt.esc_idx,
                                                     pkt.esc_val)), pkt.shape)


def _d6_mode_costs(g: np.ndarray):
    """Both predictors' residual streams and the escape bytes each costs.

    g: (N, P) u8.  Returns (bg_mean, r_mean, r_prev, cost_mean, cost_prev),
    residuals mod 256."""
    N = g.shape[0]
    s = g.sum(0, dtype=np.int64)
    bg_mean = ((s + N // 2) // N).astype(np.uint8)
    r_mean = g - bg_mean[None, :]                 # u8 wraparound
    r_prev = np.empty_like(g)
    r_prev[0] = 0
    np.subtract(g[1:], g[:-1], out=r_prev[1:])    # u8 wraparound

    def _cost(r: np.ndarray) -> int:
        # a nibble per level-1 escape and 5 bytes per level-3 escape:
        # (r + k) mod 256 <= 2k <=> centered r in [-k, k]
        n1 = int(np.count_nonzero((r + np.uint8(_D6_BIAS)) > 4))
        n3 = int(np.count_nonzero((r + np.uint8(7)) > 14))
        return n1 + 10 * n3

    return bg_mean, r_mean, r_prev, _cost(r_mean), _cost(r_prev)


def encode_delta6(gray: np.ndarray, escape_cap: int,
                  mode: Optional[int] = None) -> Optional[WirePacket6]:
    """Encode an (N, H, W) u8 stack; None on a level-3 overflow.  mode
    forces a predictor; None takes the one with the fewer escape bytes."""
    N, H, W = gray.shape
    P = H * W
    g = np.ascontiguousarray(gray.reshape(N, P))
    if native.has_symbol("swt_encode_delta6"):
        enc = native.encode_delta6(g, escape_cap, -1 if mode is None else mode)
        if enc is None:
            return None
        m, bg, lvl1, lvl2, idx3, val3 = enc
        return WirePacket6(m, bg.reshape(H, W), lvl1, lvl2, idx3, val3, (N, H, W))
    bg_mean, r_mean, r_prev, n_mean, n_prev = _d6_mode_costs(g)
    if mode is None:
        mode = 0 if n_mean <= n_prev else 1
    if mode == 0:
        r, bg = r_mean, bg_mean.reshape(H, W)
    else:
        r, bg = r_prev, np.ascontiguousarray(gray[0])
    t = r + np.uint8(_D6_BIAS)                    # 0..4 in range, > 4 escapes
    esc = t > 4
    digit = np.minimum(t, np.uint8(_D6_ESCAPE))
    Pp3 = (P + 2) // 3
    dig = np.zeros((N, 3 * Pp3), np.uint8)
    dig[:, :P] = digit
    lvl1 = dig[:, 0::3] + 6 * dig[:, 1::3] + 36 * dig[:, 2::3]
    escf = esc.reshape(-1)
    escv = r.reshape(-1)[escf]                    # mod-256 residual bytes
    u = escv + np.uint8(7)                        # 0..14 <=> [-7, 7]
    big = u > 14
    n3 = int(np.count_nonzero(big))
    if n3 > escape_cap:
        return None
    nib = np.minimum(u, np.uint8(_NIB_ESCAPE))
    if nib.size % 2:
        nib = np.append(nib, np.uint8(0))
    lvl2 = nib[0::2] | (nib[1::2] << 4)
    if lvl2.size == 0:        # the decode's gather needs a source element
        lvl2 = np.zeros(1, np.uint8)
    idx3 = np.full(escape_cap, N * P, np.int32)   # N*P: one past the end, dropped
    val3 = np.zeros(escape_cap, np.uint8)
    if n3:
        idx3[:n3] = np.flatnonzero(escf).astype(np.int32)[big]
        val3[:n3] = escv[big]
    return WirePacket6(int(mode), bg, lvl1, lvl2, idx3, val3, (N, H, W))


def decode_delta6(mode: int, bg: torch.Tensor, lvl1: torch.Tensor, lvl2: torch.Tensor,
                  esc_idx: torch.Tensor, esc_val: torch.Tensor, N: int, H: int,
                  W: int) -> torch.Tensor:
    """Inverse of encode_delta6 on the arrays' device -> (N, H, W) u8.

    Base-6 unpack; each level-1 escape's ordinal in stream order (a cumsum
    of the escape mask) picks its level-2 nibble; level 3 is scattered;
    then the predictor is added back (mode 1 through a cumsum over
    frames)."""
    P = H * W
    b = lvl1.to(torch.int32)
    q = b // 6
    digits = torch.stack((b % 6, q % 6, q // 6), dim=-1).reshape(N, -1)[:, :P]
    esc = digits == _D6_ESCAPE
    k = torch.cumsum(esc.reshape(-1), dim=0, dtype=torch.int32) - 1
    l2 = lvl2.to(torch.int32)
    nibs = torch.stack((l2 & 15, l2 >> 4), dim=-1).reshape(-1)
    nibv = nibs[k.clamp(0, nibs.numel() - 1).to(torch.int64)]
    escres = torch.where(nibv == _NIB_ESCAPE, torch.zeros_like(nibv), nibv - _NIB_BIAS)
    r = torch.where(esc.reshape(-1), escres, digits.reshape(-1) - _D6_BIAS)
    r = _scatter_drop(r, esc_idx, esc_val).reshape(N, P)
    if int(mode) == 1:
        r = torch.cumsum(r, dim=0, dtype=torch.int32)
    out = (bg.reshape(1, P).to(torch.int32) + r) & 255
    return out.to(torch.uint8).reshape(N, H, W)


def device_put_packet6(pkt: WirePacket6, device: torch.device) -> WirePacket6:
    """Start the upload of a delta6 packet's arrays to `device` (the mode
    stays on the host)."""
    device = torch.device(device)
    return WirePacket6(pkt.mode, *(_upload(a, device) for a in (pkt.bg, pkt.lvl1, pkt.lvl2,
                                                                pkt.esc_idx, pkt.esc_val)),
                       pkt.shape)


def decode_packet(pkt) -> torch.Tensor:
    """An uploaded packet of either format -> its (N, H, W) u8 batch."""
    if isinstance(pkt, WirePacket6):
        return decode_delta6(pkt.mode, pkt.bg, pkt.lvl1, pkt.lvl2, pkt.esc_idx, pkt.esc_val,
                             *pkt.shape)
    return decode_delta4(pkt.first, pkt.packed, pkt.esc_idx, pkt.esc_val, *pkt.shape)
