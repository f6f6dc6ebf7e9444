"""The port's device tracker (pipeline/tracking_device.py) vs the JAX
package's (pipeline/tracking_jax.py) on the same seeded inputs.

The cost pieces agree as far as the frameworks' float functions allow:
XLA's exp2 on the CPU lies up to 2.1e-6 from the exact value (torch's
within 7e-8), XLA may fuse the distance's multiply-add (1 ulp of a distance
below 128 moves 2^(d - 25) by up to 5.3e-6), and atan2 differs by 1 ulp,
which 2^(angle - 90) turns into up to 2.1e-5.  So the match block agrees
within rtol 1e-5 for tracks without history (distance cost only) and 5e-5
with it; the filler, diagonal and padding cells are exact;
compact_tables is bit-equal; the plain scan `track_window_reference` gives
the same state and events as the JAX scan under every JAX chunk and layout
setting, event centroids bit-equal (they are copies of the inputs).  The
CUDA kernel is held against `track_window_reference` by chip_smoke.py
(phase 11); on a CPU tensor `track_window` is the plain version."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.ops.props import RegionTable as JaxRegionTable
from swiftwatcher_tpu.ops.props import region_tables as jax_region_tables
from swiftwatcher_tpu.pipeline import tracking_jax as tj
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.ops.props import RegionTable
from swiftwatcher_tpu_torch.pipeline import tracking_device as td

ROI = np.zeros((64, 96), np.uint8)
ROI[0:40, 10:90] = 255


def _configs(**kw):
    return dataclasses.replace(DEFAULT_CONFIG, **kw), dataclasses.replace(JAX_CONFIG, **kw)


def _stream(rng, T, K, max_segments, step=6.0, empty=0.2, inactive_tail=3):
    """Seeded (cys, cxs, valids, fns, active): short random steps so tracks
    link, empty frames, valid slots as a prefix or scattered, and an
    inactive tail."""
    cys = rng.uniform(0, 64, (T, K)).astype(np.float32)
    cxs = rng.uniform(0, 96, (T, K)).astype(np.float32)
    cys[1:] = np.clip(cys[:-1] + rng.uniform(-step, step, (T - 1, K)), 0, 63)
    cxs[1:] = np.clip(cxs[:-1] + rng.uniform(-step, step, (T - 1, K)), 0, 95)
    valids = np.zeros((T, K), bool)
    for t in range(T):
        if rng.random() < empty:
            continue
        n = int(rng.integers(1, max_segments + 1))
        if rng.random() < 0.5:
            valids[t, :n] = True
        else:
            valids[t, rng.choice(K, size=min(n, K), replace=False)] = True
    active = np.ones(T, bool)
    if inactive_tail:
        active[-inactive_tail:] = False
    return cys.astype(np.float32), cxs.astype(np.float32), valids, np.arange(T, dtype=np.int32), active


def _ours(cfg, arrays, state=None, roi=ROI):
    cys, cxs, valids, fns, active = arrays
    state = td.empty_state(cys.shape[1]) if state is None else state
    return td.track_window(state, torch.from_numpy(roi), torch.from_numpy(cys),
                           torch.from_numpy(cxs), torch.from_numpy(valids),
                           torch.from_numpy(fns), cfg, active=torch.from_numpy(active))


def _theirs(cfg, arrays, state=None, chunk=1, roi=ROI):
    cys, cxs, valids, fns, active = arrays
    state = tj.empty_state(cys.shape[1]) if state is None else state
    return tj.track_window(state, jnp.asarray(roi), jnp.asarray(cys), jnp.asarray(cxs),
                           jnp.asarray(valids), jnp.asarray(fns), cfg,
                           active=jnp.asarray(active), chunk=chunk)


def _assert_same(ours, theirs, what=""):
    state, events = ours
    for name, a in state.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(theirs[0], name)),
                                      err_msg=f"state.{name} {what}")
    for name, a in events.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(theirs[1], name)),
                                      err_msg=f"events.{name} {what}")


def _random_state(rng, K, n_live):
    valid = np.zeros(K, bool)
    valid[rng.choice(K, n_live, replace=False)] = True
    return dict(
        cy=rng.uniform(0, 64, K).astype(np.float32), cx=rng.uniform(0, 96, K).astype(np.float32),
        valid=valid, hist_len=(rng.integers(0, 3, K) * valid).astype(np.int32),
        first_cy=rng.uniform(0, 64, K).astype(np.float32),
        first_cx=rng.uniform(0, 96, K).astype(np.float32), fn=np.int32(7),
    )


@pytest.mark.parametrize("K, n_live", [(8, 5), (24, 3), (24, 24), (24, 0)])
def test_cost_pieces_vs_jax(rng, K, n_live):
    cfg, jcfg = _configs(max_tracks=K)
    for _ in range(4):
        s = _random_state(rng, K, n_live)
        cy = rng.uniform(0, 64, K).astype(np.float32)
        cx = rng.uniform(0, 96, K).astype(np.float32)
        cv = rng.random(K) < 0.6
        ours_s = td.TrackState.from_numpy(s)
        theirs_s = tj.TrackState(**{k: jnp.asarray(v) for k, v in s.items()})
        m = td._match_block(ours_s, torch.from_numpy(cy), torch.from_numpy(cx), cfg).numpy()
        mj = np.asarray(tj._match_block(theirs_s, jnp.asarray(cy), jnp.asarray(cx), jcfg))
        assert m.dtype == np.float32
        hist = s["hist_len"] > 0
        np.testing.assert_allclose(m[~hist], mj[~hist], rtol=1e-5)
        np.testing.assert_allclose(m[hist], mj[hist], rtol=5e-5)
        c = td._cost_matrix(ours_s, torch.from_numpy(cy), torch.from_numpy(cx),
                            torch.from_numpy(cv), cfg).numpy()
        cj = np.asarray(tj._cost_matrix(theirs_s, jnp.asarray(cy), jnp.asarray(cx),
                                        jnp.asarray(cv), jcfg))
        block = np.zeros_like(c, bool)
        block[:K, K:] = True
        np.testing.assert_allclose(c[block], cj[block], rtol=5e-5)
        # filler, diagonal and padding cells are exact
        np.testing.assert_array_equal(c[~block], cj[~block])
        np.testing.assert_array_equal(c[block][cj[block] == td._BIG], td._BIG)
        rv = np.concatenate([s["valid"], cv])
        assert (np.diag(c) == np.where(rv, 1.0, 0.0)).all()
        assert c[0, 1] in (np.float32(1.0) + np.float32(td._EPS32), np.float32(td._BIG))


@pytest.mark.parametrize("n", range(1, 8))
def test_pattern_table_equals_jax(n):
    if n > 6:
        with pytest.raises(ValueError, match="capped at n=6"):
            td._pattern_table(n)
        return
    np.testing.assert_array_equal(td._pattern_table(n), tj._pattern_table(n))


def _region_table(rng, shape, p):
    valid = rng.random(shape) < p
    ints = {k: rng.integers(0, 99, shape).astype(np.int32)
            for k in ("sum_y", "sum_x", "min_y", "min_x", "max_y", "max_x")}
    area = (rng.integers(0, 50, shape) * valid).astype(np.int32)
    return valid, area, ints


@pytest.mark.parametrize("p", [0.0, 0.05, 0.12, 0.3, 1.0])
def test_compact_tables_bit_equal(rng, p):
    """Random (2, 3, 256) tables, with overflow (more than K valid slots)
    from p = 0.12 up; K = 24."""
    K = 24
    valid, area, ints = _region_table(rng, (2, 3, 256), p)
    ours = td.compact_tables(RegionTable(
        area=torch.from_numpy(area), valid=torch.from_numpy(valid),
        **{k: torch.from_numpy(v) for k, v in ints.items()}), K)
    theirs = tj.compact_tables(JaxRegionTable(
        area=jnp.asarray(area), valid=jnp.asarray(valid),
        **{k: jnp.asarray(v) for k, v in ints.items()}), K)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if p >= 0.3:
        assert ours[3].all()


def test_compact_tables_on_a_label_image_with_overflow():
    """K + 6 one-pixel segments: the first K in label order are kept and
    the frame is flagged (tests/test_track_overflow.py's case)."""
    from swiftwatcher_tpu_torch.ops.props import region_tables

    K = DEFAULT_CONFIG.max_tracks
    for n, flagged in ((K + 6, True), (K - 1, False)):
        lab = np.zeros((64, 96), np.uint8)
        for k in range(n):
            lab[2 + 3 * (k // 8), 2 + 3 * (k % 8)] = k + 1
        ours = td.compact_tables(region_tables(torch.from_numpy(lab[None])), K)
        theirs = tj.compact_tables(jax_region_tables(jnp.asarray(lab[None])), K)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert bool(ours[3][0]) == flagged and int(ours[2][0].sum()) == min(n, K)


# (K, track_enum_lap, most segments a frame): JV only, the enumeration with
# JV fallbacks, 6-slot enumeration, and frames over K (compacted to K).
SCANS = [(8, 0, 8), (8, 4, 8), (8, 6, 8), (24, 0, 24), (24, 4, 12), (24, 6, 24)]


@pytest.mark.parametrize("K, n_enum, most", SCANS)
def test_scan_equals_jax(rng, K, n_enum, most):
    """Against the JAX scan per frame and chunked by 8, in the plain and
    the stacked layout: equal state and events, centroids bit-equal."""
    cfg, jcfg = _configs(max_tracks=K, track_enum_lap=n_enum)
    arrays = _stream(rng, 45, K, most)
    ours = _ours(cfg, arrays)
    _assert_same(ours, _theirs(jcfg, arrays), "per frame")
    stacked = dataclasses.replace(jcfg, track_stacked_ops=True, track_scan_chunk=8)
    _assert_same(ours, _theirs(stacked, arrays, chunk=8), "chunked, stacked")
    # the port takes both settings and changes nothing
    _assert_same(_ours(dataclasses.replace(cfg, track_stacked_ops=True, track_scan_chunk=8),
                       arrays), _theirs(jcfg, arrays), "port settings")
    assert int(ours[1].count) > 0 and not bool(ours[1].overflow)


def test_scan_event_cap_overflow_equals_jax(rng):
    """Alternating full and empty frames with everything inside the ROI
    overflow the 4 * T event slots: the count saturates, the flag latches
    and the later events are dropped, as in the JAX scan."""
    K, T = DEFAULT_CONFIG.max_tracks, 12
    cfg, jcfg = _configs()
    cys = rng.uniform(0, 64, (T, K)).astype(np.float32)
    cxs = rng.uniform(0, 96, (T, K)).astype(np.float32)
    cys[1:] = np.clip(cys[:-1] + rng.uniform(-3, 3, (T - 1, K)), 0, 63)
    cxs[1:] = np.clip(cxs[:-1] + rng.uniform(-3, 3, (T - 1, K)), 0, 95)
    valids = np.zeros((T, K), bool)
    valids[::3] = True
    valids[1::3] = True
    arrays = (cys, cxs, valids, np.arange(T, dtype=np.int32), np.ones(T, bool))
    roi = np.full((64, 96), 255, np.uint8)
    ours = _ours(cfg, arrays, roi=roi)
    _assert_same(ours, _theirs(jcfg, arrays, roi=roi))
    assert bool(ours[1].overflow) and int(ours[1].count) == 4 * T


@pytest.mark.parametrize("n_enum", [2, 3, 4, 5])
def test_enumeration_equals_jv(rng, n_enum):
    """Frames that fit the first n slots take the enumeration, the rest JV:
    the same results as JV alone (tests/test_tracking_jax.py's check, on
    the port)."""
    K = DEFAULT_CONFIG.max_tracks
    for _ in range(2):
        arrays = list(_stream(rng, 40, K, n_enum, step=9.0, empty=0.15, inactive_tail=0))
        for t in range(40):                      # every fifth frame spills past n
            if t % 5 == 4:
                arrays[2][t, rng.choice(K, size=n_enum + 2, replace=False)] = True
        s_jv, e_jv = _ours(dataclasses.replace(DEFAULT_CONFIG, track_enum_lap=0), arrays)
        s_en, e_en = _ours(dataclasses.replace(DEFAULT_CONFIG, track_enum_lap=n_enum), arrays)
        for a, b in zip([*s_jv.to_numpy().values(), *e_jv.to_numpy().values()],
                        [*s_en.to_numpy().values(), *e_en.to_numpy().values()]):
            np.testing.assert_array_equal(a, b)


def test_state_carries_across_windows_from_the_jax_package(rng):
    """A JAX scan's TrackState, carried over by from_numpy, continues in the
    port as it does in the JAX package; to_numpy/from_numpy round-trips."""
    cfg, jcfg = _configs()
    K = DEFAULT_CONFIG.max_tracks
    first = _stream(rng, 30, K, 6, inactive_tail=0)
    first[2][-3:, :4] = True                     # tracks live at the window's end
    second = _stream(rng, 30, K, 6)
    jstate, _ = _theirs(jcfg, first)
    state = td.TrackState.from_numpy(jstate)
    assert int(state.valid.sum()) > 0 and int(state.hist_len.max()) > 0
    again = td.TrackState.from_numpy(state.to_numpy())
    for name, a in state.to_numpy().items():
        np.testing.assert_array_equal(a, again.to_numpy()[name])
        assert a.dtype == np.asarray(getattr(jstate, name)).dtype
    _assert_same(_ours(cfg, second, state), _theirs(jcfg, second, jstate))


def test_empty_and_inactive_frames(rng):
    """An empty frame resets the state to the frame (its zero slots kept);
    inactive frames change nothing, events included."""
    cfg, _ = _configs()
    K = DEFAULT_CONFIG.max_tracks
    arrays = _stream(rng, 10, K, 4, empty=0.0, inactive_tail=0)
    state, _ = _ours(cfg, arrays)
    cys, cxs = (rng.uniform(0, 9, (3, K)).astype(np.float32) for _ in range(2))
    empty = (cys, cxs, np.zeros((3, K), bool), np.array([20, 21, 22], np.int32),
             np.array([True, False, False]))
    after, events = _ours(cfg, empty, state)
    np.testing.assert_array_equal(after.cy.numpy(), cys[0])
    assert int(after.fn) == 20 and not after.valid.any() and not after.hist_len.any()
    assert not after.first_cy.any()
    idle = (cys, cxs, np.ones((3, K), bool), np.array([30, 31, 32], np.int32), np.zeros(3, bool))
    after, events = _ours(cfg, idle, state)
    for name, a in state.to_numpy().items():
        np.testing.assert_array_equal(a, after.to_numpy()[name])
    assert int(events.count) == 0 and events.first_cy.shape == (12,)


def test_cpu_tensors_take_the_plain_version(rng):
    cfg, _ = _configs()
    K = DEFAULT_CONFIG.max_tracks
    before = td.track_window.launches
    arrays = _stream(rng, 8, K, 3)
    t = [torch.from_numpy(a) for a in arrays]
    plain = td.track_window_reference(td.empty_state(K), torch.from_numpy(ROI), *t[:4], cfg, t[4])
    _assert_same(_ours(cfg, arrays), plain)
    assert td.track_window.launches == before
