"""T1a's plain version (pipeline/tracking_device.py:track_prologue_reference)
against the per-frame scan it feeds, and the property that lets T1b jump
over empty frames.

The prologue claims that everything but the track histories is known
before the scan: the state's positions, validity and frame number at frame
t are those of the last active frame before t, so the match block's
distance terms and current angles, the previous slots' ROI flags and each
frame's kind (inactive, empty, enumeration, JV) and next frame with work
can be computed for all frames at once.  Each test walks
`track_window_reference`'s own states frame by frame (`_step`) and holds
the prologue to them: bit-equal on the CPU, and the assembled match block
within the existing rtol of 1e-5 (no history) and 5e-5 (history) of the JAX
package's `_match_block` (XLA's CPU exp2 and atan2 differ by ulps; see
tests/test_torch_tracking_device.py).  The CUDA kernels are held to these
plain versions by chip_smoke.py (phase 11)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.pipeline import tracking_jax as tj
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.pipeline import tracking_device as td

ROI = np.zeros((64, 96), np.uint8)
ROI[0:40, 10:90] = 255
KS = [5, 24, 33, 64]


def _configs(**kw):
    return dataclasses.replace(DEFAULT_CONFIG, **kw), dataclasses.replace(JAX_CONFIG, **kw)


def _stream(rng, T, K, most, empty=0.25, inactive=(), runs=()):
    """Seeded (cys, cxs, valids, fns, active) as torch tensors: short random
    steps so tracks link; `runs` are (start, stop) stretches with no
    segment, `inactive` the inactive frames."""
    cys = rng.uniform(0, 64, (T, K)).astype(np.float32)
    cxs = rng.uniform(0, 96, (T, K)).astype(np.float32)
    cys[1:] = np.clip(cys[:-1] + rng.uniform(-6, 6, (T - 1, K)), 0, 63).astype(np.float32)
    cxs[1:] = np.clip(cxs[:-1] + rng.uniform(-6, 6, (T - 1, K)), 0, 95).astype(np.float32)
    valids = np.zeros((T, K), bool)
    for t in range(T):
        if rng.random() >= empty:
            n = int(rng.integers(1, most + 1))
            if rng.random() < 0.5:
                valids[t, :n] = True
            else:
                valids[t, rng.choice(K, size=min(n, K), replace=False)] = True
    for a, b in runs:
        valids[a:b] = False
    active = np.ones(T, bool)
    active[list(inactive)] = False
    return tuple(torch.from_numpy(a) for a in (
        cys, cxs, valids, np.arange(T, dtype=np.int32) + 50, active))


def _random_state(rng, K, live=0.5):
    valid = rng.random(K) < live
    return td.TrackState.from_numpy(dict(
        cy=rng.uniform(0, 64, K).astype(np.float32), cx=rng.uniform(0, 96, K).astype(np.float32),
        valid=valid, hist_len=(rng.integers(0, 3, K) * valid).astype(np.int32),
        first_cy=rng.uniform(0, 64, K).astype(np.float32),
        first_cx=rng.uniform(0, 96, K).astype(np.float32), fn=np.int32(7)))


def _states(state, arrays, cfg, roi=ROI):
    """track_window_reference's state before each frame."""
    cys, cxs, valids, fns, active = arrays
    events = td.empty_events(4 * cys.shape[0])
    out = []
    for t in range(cys.shape[0]):
        out.append(state)
        if active[t]:
            state = td._step(state, events, cys[t], cxs[t], valids[t], fns[t],
                             torch.from_numpy(roi), cfg)
    return out


def _prologue(state, arrays, cfg, roi=ROI):
    cys, cxs, valids, fns, active = arrays
    return td.track_prologue_reference(state, torch.from_numpy(roi), cys, cxs, valids, fns,
                                       cfg, active)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("K", KS)
def test_prologue_planes_equal_the_scans_pieces(K, seed):
    """Positions, validity, frame number and the planes at every frame are
    bit-equal to what _match_block computes from the scan's own state
    there (its expressions written out here)."""
    rng = np.random.default_rng(seed)
    cfg, _ = _configs(max_tracks=K, track_enum_lap=4 if K > 4 else 0)
    arrays = _stream(rng, 30, K, K, inactive=(3, 17, 29))
    state0 = _random_state(rng, K)
    pro = _prologue(state0, arrays, cfg)
    c = td._consts(cfg)
    cys, cxs = arrays[:2]
    for t, st in enumerate(_states(state0, arrays, cfg)):
        for got, want in ((pro.prev_cy[t], st.cy), (pro.prev_cx[t], st.cx),
                          (pro.prev_valid[t], st.valid), (pro.prev_fn[t], st.fn)):
            assert torch.equal(got, want), t
        dy = st.cy[:, None] - cys[t][None, :]
        dx = st.cx[:, None] - cxs[t][None, :]
        d = torch.sqrt(dy * dy + dx * dx)
        assert torch.equal(pro.dist[t], torch.exp2(torch.clamp_max(d - c.dist_knee, c.clamp)))
        assert torch.equal(pro.angle[t], c.deg * torch.atan2(dy, -dx))
    assert torch.equal(pro.valid, arrays[2])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("K", KS)
def test_cells_from_the_planes_equal_match_block(K, seed):
    """The planes plus the chain's angle term (old angles of the rows with
    history) give _match_block bit for bit, and the JAX package's
    _match_block within its rtol."""
    rng = np.random.default_rng(10 + seed)
    cfg, jcfg = _configs(max_tracks=K, track_enum_lap=0)
    arrays = _stream(rng, 24, K, K, empty=0.1)
    state0 = _random_state(rng, K)
    pro = _prologue(state0, arrays, cfg)
    c = td._consts(cfg)
    n_hist = 0
    for t, st in enumerate(_states(state0, arrays, cfg)):
        cells = td._assemble(pro.dist[t], pro.angle[t], st, c)
        assert torch.equal(cells, td._match_block(st, arrays[0][t], arrays[1][t], cfg)), t
        jst = tj.TrackState(**{k: jnp.asarray(v) for k, v in st.to_numpy().items()})
        mj = np.asarray(tj._match_block(jst, jnp.asarray(arrays[0][t].numpy()),
                                        jnp.asarray(arrays[1][t].numpy()), jcfg))
        hist = st.hist_len.numpy() > 0
        np.testing.assert_allclose(cells.numpy()[~hist], mj[~hist], rtol=1e-5)
        np.testing.assert_allclose(cells.numpy()[hist], mj[hist], rtol=5e-5)
        n_hist += int(hist.sum())
    assert n_hist > 0


@pytest.mark.parametrize("K", KS)
def test_roi_flags_equal_the_event_test(K):
    """The ROI flag of each previous slot is the event test's (the mask's
    pixel at the truncated, clamped centroid is 255)."""
    rng = np.random.default_rng(20 + K)
    cfg, _ = _configs(max_tracks=K)
    arrays = _stream(rng, 20, K, K)
    state0 = _random_state(rng, K)
    state0.cy[:2] = torch.tensor([-3.5, 70.0])   # clamped at both edges
    pro = _prologue(state0, arrays, cfg)
    for t, st in enumerate(_states(state0, arrays, cfg)):
        want = td._in_roi(st.cy, st.cx, torch.from_numpy(ROI))
        iy = np.clip(st.cy.numpy().astype(np.int32), 0, 63)
        ix = np.clip(st.cx.numpy().astype(np.int32), 0, 95)
        assert np.array_equal(want.numpy(), ROI[iy, ix] == 255)
        assert torch.equal(pro.roi[t], want), t


def _kinds_and_next(state0, arrays, cfg):
    """The kinds and next-work indices walked out of the scan's states."""
    cys, cxs, valids, fns, active = arrays
    T, K = cys.shape
    n = int(cfg.track_enum_lap)
    kinds = []
    for t, st in enumerate(_states(state0, arrays, cfg)):
        live = st.valid | valids[t]
        if not active[t]:
            kinds.append(td.INACTIVE)
        elif not live.any():
            kinds.append(td.EMPTY)
        elif 0 < n < K and not live[n:].any():
            kinds.append(td.ENUMERATION)
        else:
            kinds.append(td.JV)
    work = [t for t in range(T) if kinds[t] >= td.ENUMERATION]
    nxt = [min([w for w in work if w > t], default=T) for t in range(T)]
    last = max([t for t in range(T) if active[t]], default=-1)
    return kinds, nxt, last


STREAMS = {
    # runs of empty frames between busy ones, one at the batch's edge
    "empty runs, edge": dict(T=40, runs=((5, 14), (20, 31), (34, 40))),
    # an empty run at the start, an inactive tail
    "empty start, inactive tail": dict(T=30, runs=((0, 8),), inactive=(26, 27, 28, 29)),
    # inactive frames inside an empty run and between busy frames
    "inactive inside": dict(T=30, runs=((10, 20),), inactive=(2, 12, 13, 19, 21)),
    # nothing active
    "all inactive": dict(T=6, inactive=tuple(range(6))),
}


@pytest.mark.parametrize("live", [0.0, 0.5])
@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("K, n_enum", [(5, 0), (24, 4), (33, 6), (64, 4)])
def test_kinds_and_next_work(K, n_enum, name, live):
    kw = dict(STREAMS[name])
    rng = np.random.default_rng(K + 7 * n_enum + len(name))
    cfg, _ = _configs(max_tracks=K, track_enum_lap=n_enum)
    arrays = _stream(rng, kw.pop("T"), K, min(K, 6), empty=0.15, **kw)
    state0 = _random_state(rng, K, live)
    pro = _prologue(state0, arrays, cfg)
    kinds, nxt, last = _kinds_and_next(state0, arrays, cfg)
    assert pro.kind.tolist() == kinds
    assert pro.next.tolist() == nxt
    assert int(pro.last_active) == last
    assert pro.src.tolist() == [max([s for s in range(t) if arrays[4][s]], default=-1)
                                for t in range(len(kinds))]
    if name == "empty runs, edge":
        assert td.EMPTY in kinds and kinds[-1] == td.EMPTY and nxt[-1] == len(kinds)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K", KS)
def test_empty_stretch_is_the_reset_of_its_last_frame(K, seed):
    """A stretch of empty active frames (no track coming in, no segment),
    inactive frames among them, leaves the reset of its last active frame
    whatever histories came in, and appends no event; the JAX scan chunked
    by 8 gives the same."""
    rng = np.random.default_rng(30 + seed)
    cfg, jcfg = _configs(max_tracks=K)
    T = 19
    arrays = _stream(rng, T, K, K, runs=((0, T),), inactive=(4, 11, T - 1 - seed))
    state0 = _random_state(rng, K, live=0.0)
    state0.hist_len[:] = 3          # stale histories on invalid slots
    state, events = td.track_window_reference(state0, torch.from_numpy(ROI), *arrays[:4],
                                              cfg, arrays[4])
    last = max(t for t in range(T) if arrays[4][t])
    assert torch.equal(state.cy, arrays[0][last]) and torch.equal(state.cx, arrays[1][last])
    assert not state.valid.any() and not state.hist_len.any()
    assert not state.first_cy.any() and not state.first_cx.any()
    assert int(state.fn) == int(arrays[3][last]) and int(events.count) == 0
    assert set(_prologue(state0, arrays, cfg).kind.tolist()) == {td.EMPTY, td.INACTIVE}
    jstate = tj.TrackState(**{k: jnp.asarray(v) for k, v in state0.to_numpy().items()})
    js, je = tj.track_window(jstate, jnp.asarray(ROI), *(jnp.asarray(a.numpy()) for a in arrays[:4]),
                             jcfg, active=jnp.asarray(arrays[4].numpy()), chunk=8)
    for name, a in state.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(js, name)), err_msg=name)
    assert int(je.count) == 0


@pytest.mark.parametrize("K, n_enum", [(24, 4), (33, 0)])
def test_empty_stretches_inside_a_stream_equal_jax_chunked(K, n_enum):
    """Busy frames between long empty stretches (one at the edge), from a
    state with live tracks: the plain scan equals the JAX scan per frame
    and chunked by 8, state and events."""
    rng = np.random.default_rng(40 + K)
    cfg, jcfg = _configs(max_tracks=K, track_enum_lap=n_enum)
    arrays = _stream(rng, 48, K, 6, empty=0.1, runs=((6, 20), (27, 38), (44, 48)))
    state0 = _random_state(rng, K)
    ours = td.track_window_reference(state0, torch.from_numpy(ROI), *arrays[:4], cfg, arrays[4])
    jstate = tj.TrackState(**{k: jnp.asarray(v) for k, v in state0.to_numpy().items()})
    for chunk in (1, 8):
        js, je = tj.track_window(jstate, jnp.asarray(ROI),
                                 *(jnp.asarray(a.numpy()) for a in arrays[:4]), jcfg,
                                 active=jnp.asarray(arrays[4].numpy()), chunk=chunk)
        for name, a in ours[0].to_numpy().items():
            np.testing.assert_array_equal(a, np.asarray(getattr(js, name)), err_msg=name)
        for name, a in ours[1].to_numpy().items():
            np.testing.assert_array_equal(a, np.asarray(getattr(je, name)), err_msg=name)
    assert int(ours[1].count) > 0


def test_track_prologue_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    cfg, _ = _configs()
    K = DEFAULT_CONFIG.max_tracks
    arrays = _stream(rng, 10, K, 4)
    state0 = td.empty_state(K)
    before = td.track_window.launches, td.track_window.kernels
    got = td.track_prologue(state0, torch.from_numpy(ROI), *arrays[:4], cfg, arrays[4])
    want = _prologue(state0, arrays, cfg)
    for name, a in want.to_numpy().items():
        np.testing.assert_array_equal(a, got.to_numpy()[name], err_msg=name)
    td.track_window(state0, torch.from_numpy(ROI), *arrays[:4], cfg, arrays[4])
    assert (td.track_window.launches, td.track_window.kernels) == before
    assert td._record_words(K) % 4 == 0 and td._record_words(33) % 4 == 0
