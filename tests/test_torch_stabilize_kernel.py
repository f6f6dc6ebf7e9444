"""K9 (csrc/stabilize.cu), stabilisation's integer SAD search and gather,
emulated in numpy at its schedule, against the plain chain.

The kernels run only on the card, where chip_smoke.py phase 21 holds them
against `stabilize_window_reference`.  Here, on the CPU:

  * a numpy emulation of K9a (a block a band of `search_layout` rows: the
    band's rows with their J halo rows and columns clamped, staged at
    STAGE_OFF of `stride`-byte rows whose other bytes are garbage; each
    output word's (2J+1)^2 candidates formed from 3 staged words by funnel
    shifts and summed a byte lane at a time, the last word of a ragged row
    masked; the blocks' partial sums added in a shuffled order) and of K9b
    (the first warp's argmin, lanes then a shuffle-down tree with ties to
    the lowest index; the copy a word at a time with two aligned loads and
    a funnel shift, or a byte at a time where W % 4 != 0), plugged into
    `stabilize_window` in place of its launchers, gives the plain chain's
    aligned bytes and shifts bit for bit: J = 1 to 4, with a shared u8
    reference and with each window's mean, on planted shifts that reach
    the crop's edges, on widths that are a multiple of 16, of 4 and
    neither, on widths whose staged rows fill 48 KiB to within the static
    bytes (730 and 990, strides 768 and 1024), and on a flat frame whose
    candidates all tie (index 0, the shift (-J, -J));
  * the route's table, and the CPU's and J = 0's routes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from swiftwatcher_tpu_torch.ops import stabilize as stab
from swiftwatcher_tpu_torch.utils.metrics import RunMetrics, bind

OFF = stab.STAGE_OFF


def _words(rows: np.ndarray) -> np.ndarray:
    """Byte rows (k, stride) as little-endian 32-bit words, int64."""
    return rows.view("<u4").astype(np.int64)


def _funnel_r(lo, hi, shift_bytes: int):
    """__funnelshift_r(lo, hi, 8 * shift_bytes)."""
    return ((hi << 32 | lo) >> (8 * shift_bytes)) & 0xFFFFFFFF


def _sad4(x, y):
    """The sum of |x_i - y_i| over the four byte lanes."""
    return sum(np.abs((x >> (8 * i) & 0xFF) - (y >> (8 * i) & 0xFF)) for i in range(4))


def _search_block(src, ref, y0, J, rows, stride, rng):
    """One K9a block's (2J+1)^2 partial SADs of the band at y0."""
    H, W = src.shape
    n = 2 * J + 1
    nrows = min(rows, H - y0)
    pad = rng.integers(0, 256, size=(rows + 2 * J, stride), dtype=np.uint8)
    refs = rng.integers(0, 256, size=(rows, stride), dtype=np.uint8)
    for i in range(rows + 2 * J):
        row = src[min(max(y0 - J + i, 0), H - 1)]
        pad[i, OFF:OFF + W] = row
        pad[i, OFF - J:OFF] = row[0]
        pad[i, OFF + W:OFF + W + J] = row[W - 1]
    refs[:nrows, OFF:OFF + W] = ref[y0:y0 + nrows]
    pw, rw = _words(pad), _words(refs)
    kw = -(-W // 4)
    e, q = (OFF - J) & 3, (OFF - J) >> 2
    r, k = np.divmod(np.arange(nrows * kw), kw)
    mask = np.where((W % 4 != 0) & (k == kw - 1), (1 << 8 * (W % 4)) - 1, 0xFFFFFFFF)
    rword = rw[r, OFF // 4 + k] & mask
    part = np.zeros(n * n, np.int64)
    for a in range(n):
        w = [pw[r + a, q + k + i] for i in range(3)]
        for b in range(n):
            s = e + b
            wi, sh = s >> 2, s & 3
            v = w[wi] if sh == 0 else _funnel_r(w[wi], w[wi + 1], sh)
            part[a * n + b] = _sad4(v & mask, rword).sum()
    return part


def emulated_search(gray: torch.Tensor, refs: torch.Tensor, J: int) -> torch.Tensor:
    """launch_search's sads from the emulated blocks, added in a shuffled
    order into an int32 buffer."""
    g, rf = gray.numpy(), refs.numpy()
    N, H, W = g.shape
    R = rf.shape[0]
    assert N % R == 0
    T, ref_stride = N // R, (0 if R == 1 else 1)
    rows, stride = stab.search_layout(H, W, J)
    # the staged rows in dynamic shared memory beside the static `total`
    # of (2J+1)^2 int32 fit a block's 48 KiB
    assert rows >= 1 and stride % 16 == 0
    assert (2 * rows + 2 * J) * stride + 4 * (2 * J + 1) ** 2 <= stab.SMEM_BYTES
    bands = -(-H // rows)
    rng = np.random.default_rng(N * 1000 + H * 10 + J)
    parts = [(f, _search_block(g[f], rf[(f // T) * ref_stride], b * rows, J, rows, stride, rng))
             for f in range(N) for b in range(bands)]
    sads = np.zeros((N, (2 * J + 1) ** 2), np.int32)
    for i in rng.permutation(len(parts)):
        f, part = parts[i]
        assert part.max() < 2 ** 31
        sads[f] += part.astype(np.int32)
    return torch.from_numpy(sads)


def _argmin_warp(row: np.ndarray) -> int:
    """K9b's first warp: each lane the lowest index of its least sum, then
    a shuffle-down tree (a lane past the warp's end reads its own)."""
    C = len(row)
    v = np.full(32, 2 ** 31 - 1, np.int64)
    i = np.full(32, C, np.int64)
    for lane in range(32):
        for c in range(lane, C, 32):
            if row[c] < v[lane]:
                v[lane], i[lane] = row[c], c
    for o in (16, 8, 4, 2, 1):
        src = np.minimum(np.arange(32) + o, 31)
        src = np.where(np.arange(32) + o < 32, src, np.arange(32))
        ov, oi = v[src], i[src]
        take = (ov < v) | ((ov == v) & (oi < i))
        v, i = np.where(take, ov, v), np.where(take, oi, i)
    return int(i[0])


def emulated_gather(gray: torch.Tensor, sads: torch.Tensor, J: int):
    """launch_gather's (aligned, shifts), a block of GATHER_ROWS rows at a
    time: words where W % 4 == 0, else bytes."""
    g, s = gray.numpy(), sads.numpy()
    N, H, W = g.shape
    n = 2 * J + 1
    out = np.zeros_like(g)
    shifts = np.zeros((N, 2), np.int32)
    for f in range(N):
        best = _argmin_warp(s[f])
        dy, dx = best // n - J, best % n - J
        shifts[f] = dy, dx
        for y0 in range(0, H, stab.GATHER_ROWS):
            for y in range(y0, min(y0 + stab.GATHER_ROWS, H)):
                row = g[f, min(max(y + dy, 0), H - 1)]
                if W % 4:
                    out[f, y] = row[np.clip(np.arange(W) + dx, 0, W - 1)]
                    continue
                words = _words(row[None])[0]
                for k in range(W // 4):
                    c0 = 4 * k + dx
                    if 0 <= c0 and c0 + 3 < W:
                        lo, sh = c0 >> 2, c0 & 3
                        w = words[lo] if sh == 0 else _funnel_r(words[lo], words[lo + 1], sh)
                        out[f, y, 4 * k:4 * k + 4] = np.array([w], "<u4").view(np.uint8)
                    else:
                        out[f, y, 4 * k:4 * k + 4] = row[np.clip(c0 + np.arange(4), 0, W - 1)]
    return torch.from_numpy(out), torch.from_numpy(shifts)


@pytest.fixture
def emulated_k9(monkeypatch):
    """stabilize_window with the emulated K9 in place of its launchers, on
    any CPU u8 input the card's route would take."""
    card_route = stab.kernel_route

    def route(device, *args):
        return card_route(torch.device("cuda"), *args)

    monkeypatch.setattr(stab, "kernel_route", route)
    monkeypatch.setattr(stab, "launch_search", emulated_search)
    monkeypatch.setattr(stab, "launch_gather", emulated_gather)


def _shaken(rng, offsets, H, W, J):
    """Frame t: a world of 4 x 4 blocks seen at camera offset offsets[t]
    (|offset| <= J); the pose is offset (0, 0)."""
    Hw, Ww = H + 2 * J, W + 2 * J
    coarse = rng.integers(0, 256, size=(Hw // 4 + 1, Ww // 4 + 1))
    world = np.kron(coarse, np.ones((4, 4), np.int64))[:Hw, :Ww].astype(np.uint8)
    world += rng.integers(0, 3, size=world.shape, dtype=np.uint8)
    frames = np.stack([world[J + dy:J + dy + H, J + dx:J + dx + W] for dy, dx in offsets])
    return world[J:J + H, J:J + W], frames


def _planted(rng, J, T):
    """Offsets with the four corners of [-J, J]^2 (slices that reach the
    crop's edges) and random ones."""
    corners = [(-J, -J), (-J, J), (J, -J), (J, J)]
    return corners + [tuple(int(v) for v in rng.integers(-J, J + 1, 2))
                      for _ in range(T - len(corners))]


@pytest.mark.parametrize("J", [1, 2, 3, 4])
@pytest.mark.parametrize("with_ref", [True, False])
@pytest.mark.parametrize("W", [64, 52, 50, 730, 990])
def test_emulated_k9_equals_the_plain_chain(emulated_k9, J, with_ref, W):
    """Two windows of 5 frames, 40 rows (a band of `search_layout` rows
    and a ragged one)."""
    rng = np.random.default_rng(100 * J + W + with_ref)
    H, T = 40, 5
    windows, poses = [], []
    for _ in range(2):
        pose, frames = _shaken(rng, _planted(rng, J, T), H, W, J)
        windows.append(frames)
        poses.append(pose)
    gray = torch.from_numpy(np.stack(windows))
    ref = torch.from_numpy(poses[0]) if with_ref else None
    metrics = RunMetrics()
    with bind(metrics):
        aligned, shifts = stab.stabilize_window(gray, J, ref)
    want_aligned, want_shifts = stab.stabilize_window_reference(gray, J, ref)
    assert metrics.counters == {"stabilize.launches": 1}
    assert aligned.dtype == torch.uint8 and shifts.dtype == torch.int32
    assert aligned.shape == gray.shape and shifts.shape == (2, T, 2)
    assert torch.equal(aligned, want_aligned)
    assert torch.equal(shifts, want_shifts)
    if with_ref:
        # the first window was shot against the reference pose: each
        # chosen shift cancels its planted offset, edges included
        assert (shifts[0, :4].abs() == J).all()


@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_emulated_k9_flat_frames_tie_to_index_0(emulated_k9, J):
    """Every candidate of a flat frame scores the same: K9b's argmin takes
    candidate 0, the shift (-J, -J), as the plain chain does."""
    flat = torch.full((1, 3, 12, 20), 77, dtype=torch.uint8)
    for ref in (None, torch.full((12, 20), 200, dtype=torch.uint8)):
        aligned, shifts = stab.stabilize_window(flat, J, ref)
        want = stab.stabilize_window_reference(flat, J, ref)
        assert torch.equal(aligned, want[0]) and torch.equal(shifts, want[1])
        assert (shifts == -J).all()


def test_emulated_gather_breaks_lane_ties_to_the_lowest_index():
    """Equal least sums in several lanes and in one lane twice: the lowest
    index wins, as the plain chain's argmin."""
    row = np.full(81, 9, np.int64)
    row[[70, 5, 40, 37]] = 3
    assert _argmin_warp(row) == 5
    row[2] = 3
    assert _argmin_warp(row) == 2
    assert _argmin_warp(np.zeros(49, np.int64)) == 0


SHAPE = (64, 21, 216, 432)
CUDA = torch.device("cuda")


@dataclasses.dataclass
class Case:
    device: torch.device = CUDA
    dtype: torch.dtype = torch.uint8
    shape: tuple = SHAPE
    contiguous: bool = True
    J: int = 3
    ref_dtype: object = torch.uint8
    ref_shape: object = (216, 432)


@pytest.mark.parametrize("case, want", [
    (Case(), True),                                        # the cells' batch
    (Case(ref_dtype=None, ref_shape=None), True),          # each window's mean
    (Case(J=1), True),
    (Case(J=4), True),
    (Case(shape=(21, 216, 435), ref_shape=(216, 435)), True),   # W % 4 != 0: masked
    (Case(shape=(3, 1, 1), ref_shape=(1, 1)), True),
    (Case(shape=(21, 64, 730), ref_shape=(64, 730)), True),     # stride 768
    (Case(shape=(21, 64, 990), ref_shape=(64, 990)), True),     # stride 1024
    (Case(device=torch.device("cpu")), False),             # the CPU: plain
    (Case(dtype=torch.int32), False),
    (Case(contiguous=False), False),
    (Case(J=5), False),                                    # past MAX_J
    (Case(J=0), False),                                    # J = 0: identity first
    (Case(shape=(216, 432)), False),                       # no T axis
    (Case(shape=(0, 21, 216, 432)), False),                # no frame
    (Case(ref_dtype=torch.int32), False),                  # an int32 reference
    (Case(ref_shape=(1, 216, 432)), False),
    (Case(shape=(1, 3000, 3000), ref_shape=(3000, 3000)), False),   # SAD past int32
    (Case(shape=(1, 8, 30000), ref_shape=(8, 30000)), False),       # no band fits
])
def test_route_table(case, want):
    assert stab.kernel_route(case.device, case.dtype, case.shape, case.contiguous, case.J,
                             case.ref_dtype, case.ref_shape) is want


def test_cpu_and_j0_take_no_kernel(monkeypatch):
    """A CPU batch runs the plain chain (the launchers are never called);
    J = 0 returns the input itself and zero shifts."""
    def refuse(*args):
        raise AssertionError("a launcher was called")

    monkeypatch.setattr(stab, "launch_search", refuse)
    monkeypatch.setattr(stab, "launch_gather", refuse)
    rng = np.random.default_rng(5)
    gray = torch.from_numpy(rng.integers(0, 256, size=(2, 3, 16, 24), dtype=np.uint8))
    metrics = RunMetrics()
    with bind(metrics):
        got = stab.stabilize_window(gray, 2)
        same, zero = stab.stabilize_window(gray, 0)
    want = stab.stabilize_window_reference(gray, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert same is gray and zero.shape == (2, 3, 2) and not zero.any()
    assert metrics.counters == {}
