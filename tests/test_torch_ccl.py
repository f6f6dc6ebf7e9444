"""Port vs JAX package: the plain versions of K2-K5 against the Pallas
kernels in interpret mode, and label_components with its slow path; K4's
and K5's flags against a numpy reading of the JAX package's convergence
checks; the closed form K3's kernel computes, and the tile schedules of
K2's, K4's and K5's kernels emulated on tiles, against the plain versions.

Tolerance: bit-equal labels, counts, swept labels, rank maps and flagged
frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.ops.ccl import label_components as jax_label_components
from swiftwatcher_tpu.ops.ccl import wrap_labels_uint8 as jax_wrap
from scipy import ndimage

from swiftwatcher_tpu.ops.pallas.ccl_local import converge_frames as jax_converge_frames
from swiftwatcher_tpu.ops.pallas.ccl_sweep import sweep_chunk as jax_sweep_chunk
from swiftwatcher_tpu.ops.pallas.rank_compact import label_rank_fused as jax_label_rank_fused
from swiftwatcher_tpu.ops.pallas.rank_compact import rank_seed_sweep as jax_rank_seed_sweep
from swiftwatcher_tpu_torch.ops import ccl as port_ccl
from swiftwatcher_tpu_torch.ops.ccl import label_components, wrap_labels_uint8
from swiftwatcher_tpu_torch.ops.ccl_local import converge_frames, converge_frames_reference
from swiftwatcher_tpu_torch.ops.ccl_sweep import sweep_chunk, sweep_chunk_reference
from swiftwatcher_tpu_torch.ops.ccl_sweep import min_sweep
from swiftwatcher_tpu_torch.ops.rank_compact import (
    K2_SEGMENT,
    K2_TILE,
    RANK_SWEEPS,
    label_rank_fused,
    label_rank_fused_reference,
    rank_seed_sweep,
    rank_seed_sweep_reference,
)


def _snake(H, W):
    fg = np.zeros((H, W), bool)
    for r in range(0, H, 4):
        fg[r, 1 : W - 1] = True
        c = W - 2 if (r // 4) % 2 == 0 else 1
        fg[r : min(r + 4, H), c] = True
    return fg


def _scenes(rng, H=48, W=80):
    """Blobs, a line snake, empty, speckle, a serpentine and a giant
    speckle component (the last three deeper than 12 sweeps)."""
    fg = np.zeros((6, H, W), bool)
    for cy, cx, r in [(5, 7, 2), (5, 30, 1), (20, 7, 3), (40, 70, 2)]:
        fg[0, cy - r : cy + r + 1, cx - r : cx + r + 1] = True
    fg[1, 10, 5:70] = True
    fg[3] = rng.random((H, W)) > 0.75
    fg[4] = _snake(H, W)
    fg[5] = rng.random((H, W)) > 0.62
    return fg


def _converged(fg):
    """scipy oracle: every fg pixel holds its component's minimum raster
    index (f32), background H*W."""
    T, H, W = fg.shape
    idx = np.arange(H * W, dtype=np.int64).reshape(H, W)
    lbl = np.full((T, H, W), float(H * W), np.float32)
    for t in range(T):
        cc, n = ndimage.label(fg[t], structure=np.ones((3, 3)))
        if n:
            mins = np.asarray(ndimage.minimum(idx, cc, index=np.arange(1, n + 1)))
            lbl[t][fg[t]] = mins[cc[fg[t]] - 1]
    return lbl


def _slow_path_inputs(fg):
    """The planes the slow path hands K3 and K5: K2's swept labels and K4's
    rank map of the converged labels."""
    return {
        "labels": label_rank_fused_reference(torch.from_numpy(fg))[0].numpy(),
        "ranks": rank_seed_sweep_reference(torch.from_numpy(_converged(fg)))[0].numpy(),
    }


def _np_unsettled(x, fg, P):
    """The JAX package's verify_fixpoint (ops/ccl.py) in numpy, per frame:
    whether one more sweep, fg ? min(x, its 8 neighbours; out-of-frame =
    sentinel) : sentinel, would change x."""
    new = np.stack([ndimage.minimum_filter(f, size=3, mode="constant", cval=P) for f in x])
    return (np.where(fg, new, P) != x).reshape(len(x), -1).any(axis=1)


@pytest.mark.parametrize("plane", ["labels", "ranks"])
@pytest.mark.parametrize("sweeps", [1, 4])
def test_k5_plain_vs_pallas_interpret(rng, plane, sweeps):
    fg = _scenes(rng)
    P = float(fg.shape[1] * fg.shape[2])
    x = _slow_path_inputs(fg)[plane]
    want = np.asarray(jax_sweep_chunk(jnp.asarray(x), jnp.asarray(fg), sweeps, P, interpret=True))
    got, changed = sweep_chunk_reference(torch.from_numpy(x), torch.from_numpy(fg), sweeps, P)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy(), x)
    # the flag is the JAX flood's `any(new != lbl)` per frame, and after one
    # sweep its verify_fixpoint
    np.testing.assert_array_equal(changed.numpy(), (want != x).reshape(len(x), -1).any(axis=1))
    if sweeps == 1:
        np.testing.assert_array_equal(changed.numpy(), _np_unsettled(x, fg, P))


def test_k4_plain_vs_pallas_interpret(rng):
    fg = _scenes(rng)
    P = float(fg.shape[1] * fg.shape[2])
    lbl = _converged(fg)
    want = np.asarray(jax_rank_seed_sweep(jnp.asarray(lbl), RANK_SWEEPS, P, interpret=True))
    got, unsettled = rank_seed_sweep_reference(torch.from_numpy(lbl))
    np.testing.assert_array_equal(got.numpy(), want)
    flag = _np_unsettled(want, lbl < P, P)
    np.testing.assert_array_equal(unsettled.numpy(), flag)
    assert 0 < flag.sum() < len(flag)


@pytest.mark.parametrize("plane", ["labels", "ranks"])
@pytest.mark.parametrize("max_iters", [2, 64])
def test_k3_plain_vs_pallas_interpret(rng, plane, max_iters):
    """From the slow path's inputs, both under the iteration cap (2) and
    to the fixpoint (64), where labels equal the scipy oracle."""
    fg = _scenes(rng)
    P = float(fg.shape[1] * fg.shape[2])
    x = _slow_path_inputs(fg)[plane]
    want = jax_converge_frames(jnp.asarray(x), jnp.asarray(fg), max_iters, P, interpret=True)
    got = converge_frames_reference(torch.from_numpy(x), torch.from_numpy(fg), max_iters, P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if plane == "labels" and max_iters == 64:
        np.testing.assert_array_equal(got.numpy(), _converged(fg))


def test_slow_path_wrappers_take_plain_versions_on_cpu(rng):
    fg = torch.from_numpy(_scenes(rng))
    P = float(fg.shape[1] * fg.shape[2])
    lbl = label_rank_fused_reference(fg)[0]
    conv = torch.from_numpy(_converged(fg.numpy()))
    wrappers = (sweep_chunk, converge_frames, rank_seed_sweep)
    before = [w.launches for w in wrappers]
    for a, b in zip(sweep_chunk(lbl, fg, 4, P), sweep_chunk_reference(lbl, fg, 4, P)):
        assert torch.equal(a, b)
    assert torch.equal(converge_frames(lbl, fg, 8, P), converge_frames_reference(lbl, fg, 8, P))
    for a, b in zip(rank_seed_sweep(conv), rank_seed_sweep_reference(conv)):
        assert torch.equal(a, b)
    assert [w.launches for w in wrappers] == before
    meta = torch.zeros((1, 4, 4), device="meta")
    meta_fg = torch.zeros((1, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        sweep_chunk(meta, meta_fg, 4, 16.0)
    with pytest.raises(ValueError):
        converge_frames(meta, meta_fg, 8, 16.0)
    with pytest.raises(ValueError):
        rank_seed_sweep(meta)


def test_k2_plain_vs_pallas_interpret(rng):
    fg = _scenes(rng)
    H, W = fg.shape[1:]
    jl, jlab = jax_label_rank_fused(jnp.asarray(fg), RANK_SWEEPS, float(H * W), interpret=True)
    jl, jlab = np.asarray(jl), np.asarray(jlab)
    jflag = jl[:, 0, 0] < 0
    jl = np.where(jl < 0, -jl - 1, jl)           # decode the TPU's marker
    lbl, lab, flag = label_rank_fused_reference(torch.from_numpy(fg))
    np.testing.assert_array_equal(flag.numpy(), jflag)
    np.testing.assert_array_equal(lbl.numpy(), jl)
    np.testing.assert_array_equal(lab.numpy(), jlab)
    f = flag.numpy().tolist()
    assert not f[0] and not f[2] and f[1] and f[4] and f[5]


def test_k2_wrapper_takes_plain_version_on_cpu(rng):
    fg = torch.from_numpy(_scenes(rng))
    before = label_rank_fused.launches
    got = label_rank_fused(fg)
    assert label_rank_fused.launches == before
    for a, b in zip(got, label_rank_fused_reference(fg)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        label_rank_fused(torch.zeros((1, 4, 4), dtype=torch.bool, device="meta"))


def test_label_components_vs_jax_fused_path(rng, monkeypatch):
    """The fast/slow split against the JAX package's TPU path, run in
    interpret mode, including frames that take the slow path through the
    K3, K4 and K5 wrappers."""
    fg = _scenes(rng)
    jlab, jcnt = jax_label_components(jnp.asarray(fg), use_pallas=True, interpret=True)
    flagged = int(label_rank_fused_reference(torch.from_numpy(fg))[2].sum())
    calls = {}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapper

    for name in ("converge_frames", "rank_seed_sweep", "sweep_chunk"):
        monkeypatch.setattr(port_ccl, name, counted(name, getattr(port_ccl, name)))
    before = label_components.slow_path_frames
    lab, cnt = label_components(torch.from_numpy(fg))
    assert label_components.slow_path_frames - before == flagged >= 3
    assert sorted(calls) == ["converge_frames", "rank_seed_sweep", "sweep_chunk"]
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("shape,density", [((3, 60, 90), 0.62), ((2, 37, 129), 0.55)])
def test_label_components_serpentine_vs_jax(rng, shape, density):
    """Dense speckle: giant serpentine components that need pointer
    jumping, against the JAX package's off-TPU path."""
    fg = rng.random(shape) > density
    fg[0] = _snake(*shape[1:])
    jlab, jcnt = jax_label_components(jnp.asarray(fg), use_pallas=False)
    lab, cnt = label_components(torch.from_numpy(fg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_label_components_empty_and_full_frames():
    fg = np.zeros((3, 20, 30), bool)
    fg[1] = True
    fg[2, ::2, ::2] = True   # isolated pixels: 150 components
    jlab, jcnt = jax_label_components(jnp.asarray(fg), use_pallas=False)
    lab, cnt = label_components(torch.from_numpy(fg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(cnt.numpy(), [0, 1, 150])


def test_wrap_labels_uint8(rng):
    labels = rng.integers(0, 700, size=(2, 9, 11)).astype(np.int32)
    want = np.asarray(jax_wrap(jnp.asarray(labels)))
    np.testing.assert_array_equal(wrap_labels_uint8(torch.from_numpy(labels)).numpy(), want)


def _component_min_of_first_step(x, fg):
    """K3's closed form: v = the 3x3 min of x inside the frame; a fg pixel
    gets the min of v over its 8-connected component, background P."""
    T, H, W = fg.shape
    P = float(H * W)
    out = np.full((T, H, W), P, np.float32)
    for t in range(T):
        v = ndimage.minimum_filter(x[t], size=3, mode="constant", cval=P)
        cc, n = ndimage.label(fg[t], structure=np.ones((3, 3)))
        if n:
            mins = np.asarray(ndimage.minimum(v, cc, index=np.arange(1, n + 1)), np.float32)
            out[t][fg[t]] = mins[cc[fg[t]] - 1]
    return out


@pytest.mark.parametrize("plane", ["labels", "ranks"])
@pytest.mark.parametrize("background", ["sentinel", "below"])
@pytest.mark.parametrize("max_iters", [256, 0])
def test_k3_fixpoint_is_component_min_of_first_step(rng, plane, background, max_iters):
    """What K3's kernel computes for max_iters >= 1 (a union-find to the
    component minimum of the first 3x3 step) equals the plain version and
    the Pallas kernel run to their fixpoint; max_iters == 0 returns the
    input on all three."""
    fg = _scenes(rng)
    P = float(fg.shape[1] * fg.shape[2])
    x = _slow_path_inputs(fg)[plane]
    if background == "below":
        x = np.where(fg, x, rng.integers(0, int(P), size=fg.shape)).astype(np.float32)
    plain = converge_frames_reference(torch.from_numpy(x), torch.from_numpy(fg), max_iters, P)
    pallas = jax_converge_frames(jnp.asarray(x), jnp.asarray(fg), max_iters, P, interpret=True)
    want = _component_min_of_first_step(x, fg) if max_iters else x
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(np.asarray(pallas), want)
    if max_iters:
        assert not np.array_equal(want, x)


def _staged(plane, fg, y0, x0, SH, SW, fill):
    """The (SH, SW) window of one frame at (y0, x0); out-of-frame cells are
    background holding `fill`."""
    H, W = fg.shape
    a = torch.full((SH, SW), fill, dtype=plane.dtype)
    m = torch.zeros((SH, SW), dtype=torch.bool)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + SH, H), min(x0 + SW, W)
    a[ys - y0 : ye - y0, xs - x0 : xe - x0] = plane[ys:ye, xs:xe]
    m[ys - y0 : ye - y0, xs - x0 : xe - x0] = fg[ys:ye, xs:xe]
    return a, m


def _staged_sweeps(a, m, sweeps, P, clear_bg=False):
    """The kernels' sweeps in shared memory (csrc/tile_sweep.cuh): two
    planes, the second with background P; sweep k updates only the
    foreground cells at least k inside the staged edge, and the sweeps stop
    once one changes none of them.  `clear_bg` sets the first plane's
    background to P after the first sweep, before the second writes it.
    Returns (result plane, last sweep changed)."""
    planes = [a.clone(), torch.where(m, a, torch.full_like(a, P))]
    moving = True
    SH, SW = a.shape
    for k in range(1, sweeps + 1):
        if not moving:
            break
        src, dst = planes
        new = min_sweep(src[None], m[None], P)[0]
        region = (slice(k, SH - k), slice(k, SW - k))
        upd = m[region]
        moving = bool((new[region] != src[region])[upd].any())
        dst[region] = torch.where(upd, new[region], dst[region])
        if k == 1 and clear_bg and moving and sweeps > 1:
            src[~m] = P
        planes = [dst, src]
    return planes[0], moving


def _segment_ranks(roots):
    """Each root's 1-based raster rank as the kernels compute it: the
    exclusive offset of its (row, K2_SEGMENT-column segment) root count
    plus the roots of the segment up to it."""
    N, H, W = roots.shape
    nseg = -(-W // K2_SEGMENT)
    padded = torch.zeros((N, H, nseg * K2_SEGMENT), dtype=torch.int64)
    padded[:, :, :W] = roots.long()
    counts = padded.reshape(N, H * nseg, K2_SEGMENT).sum(2)
    offsets = (torch.cumsum(counts, 1) - counts).reshape(N, H, nseg)
    within = torch.cumsum(padded.reshape(N, H, nseg, K2_SEGMENT), 3).reshape(N, H, -1)[:, :, :W]
    return offsets.repeat_interleave(K2_SEGMENT, 2)[:, :, :W] + within


def _tiles(H, W, tile):
    """(own-cell slices, top row, left column) of each tile of a frame."""
    TH, TW = tile
    return [((slice(ty0, min(ty0 + TH, H)), slice(tx0, min(tx0 + TW, W))), ty0, tx0)
            for ty0 in range(0, H, TH) for tx0 in range(0, W, TW)]


def _tiled_k2(fg, tile, sweeps):
    """K2's kernel schedule on (TH, TW) tiles: label tiles staged with a halo
    of sweeps + 1 (swept labels, probe OR'd into the flag, root bits), raster
    offsets per (row, K2_SEGMENT-column segment), then per tile of a flagged
    frame the rank flood staged with a halo of `sweeps`, and on an unflagged
    frame each pixel's root rank gathered."""
    N, H, W = fg.shape
    TH, TW = tile
    P = float(H * W)
    idx = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    lbl = torch.full((N, H, W), P)
    roots = torch.zeros((N, H, W), dtype=torch.bool)
    flag = torch.zeros(N, dtype=torch.bool)
    tiles = [(ty0, tx0) for ty0 in range(0, H, TH) for tx0 in range(0, W, TW)]
    h = sweeps + 1
    for n in range(N):
        for ty0, tx0 in tiles:
            th, tw = min(TH, H - ty0), min(TW, W - tx0)
            if not fg[n, ty0 : ty0 + th, tx0 : tx0 + tw].any():
                continue
            seed, m = _staged(idx, fg[n], ty0 - h, tx0 - h, TH + 2 * h, TW + 2 * h, P)
            a, moving = _staged_sweeps(torch.where(m, seed, torch.full_like(seed, P)), m,
                                       sweeps, P)
            own = (slice(h, h + th), slice(h, h + tw))
            if moving:
                flag[n] |= bool((min_sweep(a[None], m[None], P)[0][own] != a[own]).any())
            lbl[n, ty0 : ty0 + th, tx0 : tx0 + tw] = a[own]
            roots[n, ty0 : ty0 + th, tx0 : tx0 + tw] = m[own] & (a[own] == idx[ty0 : ty0 + th, tx0 : tx0 + tw])
    rank = _segment_ranks(roots)  # at roots
    labels = torch.zeros((N, H, W), dtype=torch.int32)
    for n in range(N):
        if not flag[n]:
            r = lbl[n][fg[n]].long()
            labels[n][fg[n]] = rank[n].flatten()[r].int()
            continue
        seeds = torch.where(roots[n], rank[n].float(), torch.full((H, W), P))
        for ty0, tx0 in tiles:
            th, tw = min(TH, H - ty0), min(TW, W - tx0)
            if not fg[n, ty0 : ty0 + th, tx0 : tx0 + tw].any():
                continue
            a, m = _staged(seeds, fg[n], ty0 - sweeps, tx0 - sweeps,
                           TH + 2 * sweeps, TW + 2 * sweeps, P)
            a = _staged_sweeps(a, m, sweeps, P)[0]
            own = (slice(sweeps, sweeps + th), slice(sweeps, sweeps + tw))
            labels[n, ty0 : ty0 + th, tx0 : tx0 + tw] = torch.where(m[own], a[own], 0.0).int()
    return lbl, labels, flag


@pytest.mark.parametrize("tile", [K2_TILE, (20, 48), (13, 32)])
def test_k2_tiled_schedule_equals_plain(rng, tile):
    """The kernel's tile decomposition (at its own tile shape and at two that
    divide neither H nor W) gives the plain version's swept labels, compact
    labels and flags bit for bit, on frames it flags and frames it does not."""
    fg = torch.from_numpy(_scenes(rng))
    got = _tiled_k2(fg, tile, RANK_SWEEPS)
    want = label_rank_fused_reference(fg, RANK_SWEEPS)
    assert 0 < int(want[2].sum()) < fg.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tiled_k4(lbl, tile, sweeps):
    """K4's kernel schedule on (TH, TW) tiles: roots per (row, segment) of
    each tile (a tile without foreground records none), their raster
    offsets, then per tile with foreground the rank flood staged with a
    halo of sweeps + 1 from the staged roots, and the probe on the tile's
    own cells OR'd into the frame's flag; a tile without foreground writes
    the sentinel."""
    N, H, W = lbl.shape
    TH, TW = tile
    P = float(H * W)
    fg = lbl < P
    roots = lbl == torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    seeds = torch.where(roots, _segment_ranks(roots).float(), torch.full_like(lbl, P))
    out = torch.full_like(lbl, P)
    flag = torch.zeros(N, dtype=torch.bool)
    h = sweeps + 1
    for n in range(N):
        for cells, ty0, tx0 in _tiles(H, W, tile):
            if not fg[n][cells].any():
                continue
            a, m = _staged(seeds[n], fg[n], ty0 - h, tx0 - h, TH + 2 * h, TW + 2 * h, P)
            a, moving = _staged_sweeps(a, m, sweeps, P)
            th, tw = out[n][cells].shape
            mine = (slice(h, h + th), slice(h, h + tw))
            out[n][cells] = a[mine]
            if moving:
                flag[n] |= bool((min_sweep(a[None], m[None], P)[0][mine] != a[mine]).any())
    return out, flag


@pytest.mark.parametrize("tile", [K2_TILE, (20, 48), (13, 32)])
@pytest.mark.parametrize("sweeps", [0, 1, RANK_SWEEPS])
def test_k4_tiled_schedule_equals_plain(rng, tile, sweeps):
    """K4's tile decomposition gives the plain version's rank map and
    unsettled flags bit for bit, on components shallower and deeper than
    its sweeps."""
    lbl = torch.from_numpy(_converged(_scenes(rng)))
    got = _tiled_k4(lbl, tile, sweeps)
    want = rank_seed_sweep_reference(lbl, sweeps)
    if sweeps == RANK_SWEEPS:
        assert 0 < int(want[1].sum()) < lbl.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tiled_k5(x, fg, tile, sweeps, P):
    """K5's kernel schedule on (TH, TW) tiles: a tile without foreground
    writes the sentinel and flags its frame if any of its input cells held
    something else; any other tile stages the plane with a halo of `sweeps`
    (its background reset after the first sweep where it held values other
    than the sentinel), sweeps, writes its cells and flags its frame if any
    differs from its input."""
    N, H, W = x.shape
    TH, TW = tile
    out = torch.full_like(x, P)
    changed = torch.zeros(N, dtype=torch.bool)
    h = sweeps
    for n in range(N):
        for cells, ty0, tx0 in _tiles(H, W, tile):
            if not fg[n][cells].any():
                changed[n] |= bool((x[n][cells] != P).any())
                continue
            a, m = _staged(x[n], fg[n], ty0 - h, tx0 - h, TH + 2 * h, TW + 2 * h, P)
            dirty = bool((~m & (a != P)).any())
            a = _staged_sweeps(a, m, sweeps, P, clear_bg=dirty)[0]
            th, tw = out[n][cells].shape
            mine = a[h : h + th, h : h + tw]
            out[n][cells] = mine
            changed[n] |= bool((mine != x[n][cells]).any())
    return out, changed


@pytest.mark.parametrize("tile", [K2_TILE, (20, 48), (13, 32)])
@pytest.mark.parametrize("sweeps", [1, 4, 8])
@pytest.mark.parametrize("plane", ["labels", "ranks"])
@pytest.mark.parametrize("background", ["sentinel", "below"])
def test_k5_tiled_schedule_equals_plain(rng, tile, sweeps, plane, background):
    """K5's tile decomposition gives the plain version's swept plane and
    changed flags bit for bit, also where the background holds values below
    the sentinel (the first sweep reads them) and on frames a sweep leaves
    as they are."""
    fg_np = _scenes(rng)
    P = float(fg_np.shape[1] * fg_np.shape[2])
    x = _slow_path_inputs(fg_np)[plane]
    if background == "below":
        x = np.where(fg_np, x, rng.integers(0, int(P), size=fg_np.shape)).astype(np.float32)
    x, fg = torch.from_numpy(x), torch.from_numpy(fg_np)
    got = _tiled_k5(x, fg, tile, sweeps, P)
    want = sweep_chunk_reference(x, fg, sweeps, P)
    if background == "sentinel":
        assert 0 < int(want[1].sum()) < x.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
