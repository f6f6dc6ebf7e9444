"""The warm IALM trip's plain chain and the algorithm of its kernels (K8).

The kernels (csrc/ialm_trip.cu) run only on the card, where chip_smoke.py
phase 20 holds them against `ialm_trip_reference`.  Here, on the CPU:

  * the solver's plain route is the pre-change chain bit for bit (its
    `update`, and the whole solve, warm and cold, copied below as they
    stood), with f32 and bf16 state and u8 and f32 X;
  * `ialm_trip` on CPU tensors, warm and cold, updates A, E and Y in place
    as the pre-change loop's stores and freeze did;
  * a numpy f32 emulation of K8a and K8b, at the kernels' per-column order
    (W1 over the rows in order, Aupd over the padded rows in order, each
    step an f32 fma) and their block schedule (the Gram's 4 x 4 blocks and
    slices, zz's threads, halving tree and blocks in order), reproduces the
    plain trip: E and its store bit-equal, C and each window's sum of Z^2
    within ops/ialm_trip.py's C_RTOL and ZZ_RTOL (another summation order
    than a GEMM's), A and Y stored as bf16 within one bf16 step at their
    largest magnitude (STATE_RTOL) and in f32 within 1e-5 of it;
  * a frozen window keeps A, E and Y bit for bit;
  * the route's table.

The fma is emulated in f64 (an f32 product is exact there), which may round
twice where the card rounds once: the emulation is held to tolerances, as
the kernels are, except for E, which has no fma.
"""

from typing import Optional, Tuple

import numpy as np
import pytest
import torch

from swiftwatcher_tpu_torch.ops import ialm_trip as k8
from swiftwatcher_tpu_torch.ops.ialm_front import (
    front_chain,
    gram_blocks,
    ialm_front,
    ialm_front_reference,
)
from swiftwatcher_tpu_torch.ops.refined_eigh import refined_eigh
from swiftwatcher_tpu_torch.ops.rpca import _DTYPES, ialm_rpca_batched
from swiftwatcher_tpu_torch.utils.metrics import span

from oracles import make_synthetic_window

LMBDA, RHO, MU_CAP = 0.01, 1.5, 1e7


def _t(a):
    return a.transpose(-1, -2)


def _pre_change_update(Xs, A_s, Y_s, mu, V, lmbda, rho, mu_cap):
    """The warm branch of the solver's `update` as it stood before K8."""
    dtype = mu.dtype
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    Y = Y_s.to(dtype)
    Xf = Xs.to(dtype)
    Eupd, M = front_chain(Xs, A_s, Y_s, 1.0 / mu, lmbda)
    V0 = V
    W1 = _t(V0) @ M
    C = W1 @ _t(W1)
    d, V1 = refined_eigh(C)
    S = torch.sqrt(torch.clamp(d, min=0.0))
    Vn = V0 @ V1
    floor = eps * S.amax(dim=-1, keepdim=True) + tiny
    ratio = (S - (1.0 / mu)[..., None]) / torch.maximum(S, floor)
    Q = (Vn * ratio[..., None, :]) @ _t(V1)
    Aupd = Q @ W1
    Z = Xf - Aupd - Eupd
    Ynew = Y + mu[..., None, None] * Z
    mu_new = torch.minimum(mu * rho, mu * mu_cap)
    return Aupd, Eupd, Ynew, mu_new, Vn, Z


def _pre_change_solver(X, lmbda=0.01, tol=0.001, max_iter=100, rho=1.5, mu_cap=1e7,
                       fused_front=False, warm_basis=False, x_store_dtype=None,
                       store_y_dtype=None, store_ae_dtype=None, fixed_iters=0):
    """ialm_rpca_batched as it stood before K8 (no group)."""
    dtype = X.dtype
    sd_x = _DTYPES[x_store_dtype] if x_store_dtype else None
    sd_y = _DTYPES[store_y_dtype] if store_y_dtype else None
    sd_ae = _DTYPES[store_ae_dtype] if store_ae_dtype else None
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    frob = torch.sqrt((X * X).sum(dim=(-2, -1))).clamp(min=1e-12)
    norm_inf = X.abs().amax(dim=(-2, -1)) / lmbda
    dual = torch.maximum(frob, norm_inf)
    Y0 = X / dual[..., None, None]
    mu0 = 1.25 / frob
    Xs = X.to(sd_x) if sd_x is not None else X
    front = ialm_front if fused_front else ialm_front_reference

    def update(A_s, Y_s, mu, V):
        Y = Y_s.to(dtype)
        Xf = Xs.to(dtype)
        if warm_basis:
            Eupd, M = front_chain(Xs, A_s, Y_s, 1.0 / mu, lmbda)
            V0 = V
        else:
            Eupd, M, G = front(Xs, A_s, Y_s, 1.0 / mu, lmbda)
            _, V0 = refined_eigh(G)
        W1 = _t(V0) @ M
        C = W1 @ _t(W1)
        d, V1 = refined_eigh(C)
        S = torch.sqrt(torch.clamp(d, min=0.0))
        Vn = V0 @ V1
        floor = eps * S.amax(dim=-1, keepdim=True) + tiny
        ratio = (S - (1.0 / mu)[..., None]) / torch.maximum(S, floor)
        Q = (Vn * ratio[..., None, :]) @ _t(V1)
        Aupd = Q @ W1
        Z = Xf - Aupd - Eupd
        Ynew = Y + mu[..., None, None] * Z
        mu_new = torch.minimum(mu * rho, mu * mu_cap)
        return Aupd, Eupd, Ynew, mu_new, Vn, Z

    def store(a, sd):
        return a.to(sd) if sd is not None else a

    B, T = X.shape[0], X.shape[1]
    if warm_basis:
        M0 = X + (1.0 / mu0)[..., None, None] * Y0
        _, V = refined_eigh(M0 @ _t(M0))
    else:
        V = torch.eye(T, dtype=dtype, device=X.device).expand(B, T, T)
    A = E = torch.zeros_like(X, dtype=sd_ae if sd_ae is not None else dtype)
    Y = store(Y0, sd_y)
    mu = mu0
    if fixed_iters > 0:
        for _ in range(fixed_iters):
            Aupd, Eupd, Ynew, mu, V, _ = update(A, Y, mu, V)
            A, E, Y = store(Aupd, sd_ae), store(Eupd, sd_ae), store(Ynew, sd_y)
        iters = torch.full((B,), fixed_iters, dtype=torch.int32, device=X.device)
        return A.to(dtype), E.to(dtype), iters
    itr = torch.zeros((B,), dtype=torch.int32, device=X.device)
    err = torch.full((B,), float("inf"), dtype=dtype, device=X.device)
    while True:
        active = (err >= tol) & (itr < max_iter)
        with span("sync.ialm_stop"):
            done = not bool(active.any())
        if done:
            break
        Aupd, Eupd, Ynew, mu_new, Vn, Z = update(A, Y, mu, V)
        err_new = torch.sqrt((Z * Z).sum(dim=(-2, -1))) / frob
        keep = active[..., None, None]
        A = torch.where(keep, store(Aupd, sd_ae), A)
        E = torch.where(keep, store(Eupd, sd_ae), E)
        Y = torch.where(keep, store(Ynew, sd_y), Y)
        mu = torch.where(active, mu_new, mu)
        V = torch.where(keep, Vn, V)
        itr = itr + active.to(torch.int32)
        err = torch.where(active, err_new, err)
    return A.to(dtype), E.to(dtype), itr


def _windows(rng, B, T, P) -> torch.Tensor:
    """(B, T, P) u8 windows of synthetic swifts over a noisy background."""
    H = 11 if P % 11 == 0 else 8
    return torch.from_numpy(np.stack(
        [make_synthetic_window(rng, T=T, H=H, W=P // H) for _ in range(B)]).reshape(B, T, P))


def _trip_state(X_u8: torch.Tensor, trips: int, x_u8: bool, state: Optional[torch.dtype]):
    """(Xs, A, Y, mu, V) as the warm solver holds them after `trips` trips of
    the plain chain (no window frozen)."""
    X = X_u8.float()
    frob = torch.sqrt((X * X).sum(dim=(-2, -1))).clamp(min=1e-12)
    dual = torch.maximum(frob, X.abs().amax(dim=(-2, -1)) / LMBDA)
    Y0 = X / dual[..., None, None]
    mu = 1.25 / frob
    M0 = X + (1.0 / mu)[..., None, None] * Y0
    _, V = refined_eigh(M0 @ _t(M0))
    Xs = X_u8 if x_u8 else X
    sd = state or torch.float32
    A, Y = torch.zeros_like(X, dtype=sd), Y0.to(sd)
    for _ in range(trips):
        Aupd, _, Ynew, mu, V, _ = k8.ialm_trip_reference(Xs, A, Y, mu, V, LMBDA, RHO, MU_CAP)
        A, Y = Aupd.to(sd), Ynew.to(sd)
    return Xs, A, Y, mu, V


CASES = [((3, 21, 517), True, torch.bfloat16), ((3, 21, 517), False, torch.float32),
         ((2, 7, 64), True, torch.float32), ((2, 7, 64), False, torch.bfloat16)]


@pytest.mark.parametrize("shape,x_u8,state", CASES)
@pytest.mark.parametrize("trips", [0, 3])
def test_reference_is_the_pre_change_update(rng, shape, x_u8, state, trips):
    Xs, A, Y, mu, V = _trip_state(_windows(rng, *shape), trips, x_u8, state)
    got = k8.ialm_trip_reference(Xs, A, Y, mu, V, LMBDA, RHO, MU_CAP)
    want = _pre_change_update(Xs, A, Y, mu, V, LMBDA, RHO, MU_CAP)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("x_store,state,fixed", [
    ("uint8", "bfloat16", 0), (None, None, 0), ("uint8", None, 4), (None, "bfloat16", 3)])
def test_solver_on_the_cpu_is_the_pre_change_solver(rng, warm, x_store, state, fixed):
    X = _windows(rng, 2, 21, 8 * 40).float()
    kw = dict(lmbda=LMBDA, warm_basis=warm, x_store_dtype=x_store, store_y_dtype=state,
              store_ae_dtype=state, fixed_iters=fixed)
    for g, w in zip(ialm_rpca_batched(X, **kw), _pre_change_solver(X, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("warm,fused", [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("x_u8,state", [(False, torch.float32), (True, torch.bfloat16)])
@pytest.mark.parametrize("mask", [None, [True, False, True]])
def test_trip_on_the_cpu_is_the_pre_change_trip_and_freeze(rng, warm, fused, x_u8, state,
                                                           mask):
    """ialm_trip's plain route: A, E and Y in place as the pre-change loop
    stored and froze them, and (mu_new, Vn, zz) as its trip gave them, bit
    for bit.  A cold trip is the warm chain from the eigenbasis of K6's
    plain Gram."""
    Xs, A, Y, mu, V = _trip_state(_windows(rng, 3, 21, 517), 2, x_u8, state)
    E = torch.full_like(A, 7.0)
    V0 = V if warm else refined_eigh(ialm_front_reference(Xs, A, Y, 1.0 / mu, LMBDA)[2])[1]
    Aupd, Eupd, Ynew, mu_new, Vn, Z = _pre_change_update(Xs, A, Y, mu, V0, LMBDA, RHO, MU_CAP)
    active = None if mask is None else torch.tensor(mask)
    want = [new.to(state) if active is None else torch.where(active[..., None, None],
                                                             new.to(state), old)
            for new, old in ((Aupd, A), (Eupd, E), (Ynew, Y))]
    got = [t.clone() for t in (A, E, Y)]
    out = k8.ialm_trip(Xs, *got, mu, V, active, LMBDA, RHO, MU_CAP, warm=warm, fused_front=fused)
    want += [mu_new, Vn, (Z * Z).sum(dim=(-2, -1))]
    for g, w in zip(got + list(out), want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _fma(a, b, c):
    """f32 fmaf, emulated in f64 (the product of two f32 is exact there)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _emulate(Xs, A, Y, mu, V0, active, n_blocks: int, rotate_with=k8.rotation):
    """K8a, the T x T step and K8b in numpy f32 at the kernels' schedule.
    Returns (C, A, E, Y, zz) as the kernels leave them (A, E, Y in their
    storage dtype, frozen windows untouched)."""
    B, T, P = Xs.shape
    sd = A.dtype
    tp, blocks, slices = gram_blocks(T)     # K6's schedule
    n_chunks = -(-P // k8.CHUNK)
    pp = n_chunks * k8.CHUNK
    inside = np.zeros(pp, bool)
    inside[:P] = True

    def pad(t):
        out = np.zeros((B, T, pp), np.float32)
        out[..., :P] = t.float().numpy()
        return out

    x, a, y = pad(Xs), pad(A), pad(Y)
    im = (1.0 / mu).numpy()[:, None, None]
    mub = mu.numpy()[:, None, None]
    shrink = np.float32(LMBDA) * im
    iy = im * y
    eraw = x - a + iy
    e = np.maximum(eraw - shrink, np.float32(0)) + np.minimum(eraw + shrink, np.float32(0))
    m = np.where(inside, x - e + iy, np.float32(0))
    v0 = np.zeros((B, tp, tp), np.float32)
    v0[:, :T, :T] = V0.numpy()
    w1 = np.zeros((B, tp, pp), np.float32)
    for j in range(T):                       # rows of M in order
        w1 = _fma(v0[:, j, :, None], m[:, j, None, :], w1)

    # K8a's Gram: per grid block, per 4 x 4 block of rows and per slice of
    # the chunk's float4 groups (g = slice, slice + slices, ...), x y z w
    groups = k8.CHUNK // 4
    per_slice = -(-groups // slices)
    I = np.array([4 * i for i, _ in blocks])
    J = np.array([4 * j for _, j in blocks])
    C = np.zeros((B, T, T), np.float32)
    for blk in range(n_blocks):
        acc = np.zeros((B, len(blocks), slices, 4, 4), np.float32)
        for c in range(blk, n_chunks, n_blocks):
            tile = np.zeros((B, tp, per_slice * slices, 4), np.float32)
            tile[:, :, :groups] = w1[:, :, c * k8.CHUNK:(c + 1) * k8.CHUNK].reshape(
                B, tp, groups, 4)
            # (B, rows, k, slice, 4): group k * slices + slice
            tile = tile.reshape(B, tp, per_slice, slices, 4)
            for k in range(per_slice):
                for comp in range(4):
                    vi = np.stack([tile[:, i0:i0 + 4, k, :, comp] for i0 in I], 1)
                    vj = np.stack([tile[:, j0:j0 + 4, k, :, comp] for j0 in J], 1)
                    # (B, blocks, 4, slices) -> (B, blocks, slices, 4 ii, 4 jj)
                    prod_i = vi.transpose(0, 1, 3, 2)[..., :, None]
                    prod_j = vj.transpose(0, 1, 3, 2)[..., None, :]
                    acc = _fma(prod_i, prod_j, acc)
        part = np.zeros((B, T, T), np.float32)
        for p_i in range(T):
            for p_j in range(p_i + 1):
                bk = blocks.index((p_i // 4, p_j // 4))
                s = np.zeros(B, np.float32)
                for sl in range(slices):
                    s = s + acc[:, bk, sl, p_i % 4, p_j % 4]
                part[:, p_i, p_j] = s
        C = C + part
    C = np.tril(C) + np.transpose(np.tril(C, -1), (0, 2, 1))
    live = np.ones(B, bool) if active is None else active.numpy()
    C[~live] = 0
    Ct = torch.from_numpy(C)
    Q, _ = rotate_with(Ct, V0, mu)

    # K8b: Aupd over the padded rows of Q in order, then Z, Ynew and zz
    q = np.zeros((B, tp, tp), np.float32)
    q[:, :T, :T] = Q.numpy()
    au = np.zeros((B, T, pp), np.float32)
    for r in range(T):
        s = np.zeros((B, pp), np.float32)
        for k in range(tp):
            s = _fma(q[:, r, k, None], w1[:, k], s)
        au[:, r] = s
    z = np.where(inside, x - au - e, np.float32(0))
    yn = y + mub * z
    zc = z.reshape(B, T, n_chunks, k8.KERNEL_THREADS, 2)
    zz = np.zeros(B, np.float32)
    for blk in range(n_blocks):
        acc = np.zeros((B, k8.KERNEL_THREADS), np.float32)
        for c in range(blk, n_chunks, n_blocks):
            for r in range(T):
                for p2 in range(2):
                    v = zc[:, r, c, :, p2]
                    acc = _fma(v, v, acc)
        s = k8.KERNEL_THREADS // 2
        while s:
            acc = np.concatenate([acc[:, :s] + acc[:, s:2 * s], acc[:, 2 * s:]], 1)
            s //= 2
        zz = zz + acc[:, 0]
    zz[~live] = 0

    def stored(new, old):
        t = torch.from_numpy(np.ascontiguousarray(new[..., :P])).to(sd)
        t[torch.from_numpy(~live)] = old[torch.from_numpy(~live)]
        return t

    E_old = torch.zeros_like(A)
    return (Ct, stored(au, A), stored(e, E_old), stored(yn, Y), torch.from_numpy(zz))


def _gap(got, want) -> float:
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("shape,x_u8,state", CASES)
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_kernel_schedule_reproduces_the_plain_trip(rng, shape, x_u8, state, n_blocks):
    Xs, A, Y, mu, V = _trip_state(_windows(rng, *shape), 4, x_u8, state)
    C, A1, E1, Y1, zz = _emulate(Xs, A, Y, mu, V, None, n_blocks)
    Aupd, Eupd, Ynew, _, _, Z = k8.ialm_trip_reference(Xs, A, Y, mu, V, LMBDA, RHO, MU_CAP)
    Ep, Mp = front_chain(Xs, A, Y, 1.0 / mu, LMBDA)
    W1 = _t(V) @ Mp
    Cp = W1 @ _t(W1)
    assert torch.equal(E1, Eupd.to(state)) and torch.equal(Ep, Eupd)
    assert _gap(C, Cp) <= k8.C_RTOL
    assert float(((zz - (Z * Z).sum(dim=(-2, -1))).abs() / (Z * Z).sum(dim=(-2, -1))).max()) \
        <= k8.ZZ_RTOL
    assert _gap(A1.bfloat16(), Aupd.bfloat16()) <= k8.STATE_RTOL
    assert _gap(Y1.bfloat16(), Ynew.bfloat16()) <= k8.STATE_RTOL
    if state == torch.float32:
        assert _gap(A1, Aupd) <= 1e-5 and _gap(Y1, Ynew) <= 1e-5


def test_kernel_schedule_gram_is_the_plain_gram_of_its_w1(rng):
    """The blocked Gram alone, on W1 computed the kernels' way: C within
    C_RTOL of W1 W1^T, symmetric, its padded rows never read."""
    Xs, A, Y, mu, V = _trip_state(_windows(rng, 2, 21, 8 * 130), 2, True, torch.bfloat16)
    C, *_ = _emulate(Xs, A, Y, mu, V, None, 3)
    Ep, Mp = front_chain(Xs, A, Y, 1.0 / mu, LMBDA)
    W1 = _t(V) @ Mp
    assert torch.equal(C, _t(C)) and _gap(C, W1 @ _t(W1)) <= k8.C_RTOL


def test_frozen_windows_keep_their_state(rng):
    Xs, A, Y, mu, V = _trip_state(_windows(rng, 3, 21, 517), 2, True, torch.bfloat16)
    active = torch.tensor([True, False, True])
    C, A1, E1, Y1, zz = _emulate(Xs, A, Y, mu, V, active, 1)
    _, A2, E2, Y2, zz2 = _emulate(Xs, A, Y, mu, V, None, 1)
    assert torch.equal(A1[1], A[1]) and torch.equal(Y1[1], Y[1])
    assert bool((E1[1] == 0).all()) and float(zz[1]) == 0 and bool((C[1] == 0).all())
    for new, full in ((A1, A2), (E1, E2), (Y1, Y2)):
        assert torch.equal(new[::2], full[::2])
    assert torch.equal(zz[::2], zz2[::2])


def test_plain_solver_freezes_a_converged_window(rng):
    """On the plain route a window that converges first keeps the A and E
    of its last trip while the other runs on: they equal a fixed-trip
    solve of the same batch stopped at that trip."""
    a = _windows(rng, 1, 21, 8 * 40).float()
    X = torch.cat([a, torch.full_like(a, 100.0)])       # a flat window converges at once
    kw = dict(lmbda=LMBDA, warm_basis=True, x_store_dtype="uint8", store_y_dtype="bfloat16",
              store_ae_dtype="bfloat16")
    A, E, it = ialm_rpca_batched(X, **kw)
    assert int(it[1]) < int(it[0])
    Af, Ef, _ = ialm_rpca_batched(X, fixed_iters=int(it[1]), **kw)
    assert torch.equal(A[1], Af[1]) and torch.equal(E[1], Ef[1])


ROUTE = [
    # (device, dtype, shape, X held, state, Y held, warm) -> K8
    (("cuda", torch.float32, (64, 21, 93312), torch.uint8, torch.bfloat16, torch.bfloat16,
      True), True),
    (("cuda", torch.float32, (2, 32, 7), torch.float32, torch.float32, torch.float32, True),
     True),
    (("cuda", torch.float32, (1, 1, 1), torch.uint8, torch.float32, torch.float32, True), True),
    (("cpu", torch.float32, (64, 21, 93312), torch.uint8, torch.bfloat16, torch.bfloat16,
      True), False),
    (("cuda", torch.float64, (64, 21, 93312), torch.uint8, torch.float64, torch.float64,
      True), False),
    (("cuda", torch.float32, (4, 33, 100), torch.uint8, torch.bfloat16, torch.bfloat16, True),
     False),
    (("cuda", torch.float32, (64, 21, 93312), torch.uint8, torch.bfloat16, torch.bfloat16,
      False), False),
    (("cuda", torch.float32, (64, 21, 93312), torch.uint8, torch.bfloat16, torch.float32,
      True), False),
    (("cuda", torch.float32, (64, 21, 93312), torch.float16, torch.float32, torch.float32,
      True), False),
    (("cuda", torch.float32, (65536, 21, 8), torch.uint8, torch.bfloat16, torch.bfloat16,
      True), False),
]


@pytest.mark.parametrize("args,want", ROUTE)
def test_route_table(args, want):
    assert k8.kernel_route(*args) is want


@pytest.mark.parametrize("B,P,sms,want", [(64, 93312, 132, 4), (16, 93312, 132, 16),
                                          (1, 93312, 132, 183), (1, 100, 132, 1),
                                          (300, 93312, 132, 1)])
def test_blocks_per_window(B, P, sms, want):
    assert k8.blocks_per_window(B, P, sms) == want


def test_wrappers_raise_on_cpu_tensors():
    X = torch.zeros((1, 3, 8), dtype=torch.uint8)
    A = torch.zeros((1, 3, 8), dtype=torch.bfloat16)
    mu = torch.ones(1)
    V = torch.eye(3)[None]
    with pytest.raises(ValueError, match="unsupported device"):
        k8.launch_front(X, A, A, mu, V, None, LMBDA)
    with pytest.raises(ValueError, match="unsupported device"):
        k8.launch_back(X, A, A.clone(), A.clone(), mu, mu, V, V, None, LMBDA)
