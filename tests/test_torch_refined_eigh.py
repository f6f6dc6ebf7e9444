"""K7, the refined eigendecomposition (ops/refined_eigh.py).

The CUDA kernel runs only on the card, where chip_smoke.py holds it against
`refined_eigh_reference`.  Here: its round-robin schedule, its route, the
reference (the parent's plain chain, moved unchanged), and the kernel's
algorithm emulated in numpy f32 (`_k7`: Jacobi on the lower triangle to the
kernel's tolerance, sort, then the Newton steps with LAPACK-style
Householder QR), held against numpy's float64 eigh and, inside the IALM
solver, against the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from swiftwatcher_tpu_torch import build
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.ops import ialm_trip, rpca
from swiftwatcher_tpu_torch.ops.refined_eigh import (
    JACOBI_TOL,
    MAX_N,
    MAX_SWEEPS,
    NEWTON_STEPS,
    jacobi_partner,
    jacobi_schedule,
    kernel_route,
    launch_refined_eigh,
    refined_eigh,
    refined_eigh_reference,
)
from swiftwatcher_tpu_torch.utils import metrics

F32 = np.float32
TOL = 1e-5
P_CELL = 216 * 432   # the cells' crop: P = 93312


# --- the schedule ----------------------------------------------------------

@pytest.mark.parametrize("n", [21, 1, 2, 3, 20, 32])
def test_schedule_pairs_every_index_pair_once_a_sweep(n):
    m, steps = jacobi_schedule(n)
    assert m == n + n % 2 and len(steps) == m - 1
    seen = []
    for pairs in steps:
        assert len(pairs) == m // 2
        members = [i for pair in pairs for i in pair]
        assert sorted(members) == list(range(m))   # disjoint, every index once
        seen += [(p, q) for p, q in pairs if q < n]
    assert sorted(seen) == [(i, j) for i in range(n) for j in range(i + 1, n)]


def test_schedule_partner_is_an_involution():
    m = 22
    for r in range(m - 1):
        for i in range(m):
            j = jacobi_partner(i, r, m)
            assert j != i and jacobi_partner(j, r, m) == i


# --- the route -------------------------------------------------------------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device, dtype, shape, kernel", [
    (CUDA, torch.float32, (64, 21, 21), True),
    (CUDA, torch.float32, (21, 21), True),
    (CUDA, torch.float32, (2, 3, 32, 32), True),
    (CUDA, torch.float32, (5, 1, 1), True),
    (CUDA, torch.float32, (4, 33, 33), False),
    (CUDA, torch.float32, (0, 21, 21), False),
    (CUDA, torch.float32, (4, 21, 20), False),
    (CUDA, torch.float32, (21,), False),
    (CUDA, torch.float64, (64, 21, 21), False),
    (CUDA, torch.bfloat16, (64, 21, 21), False),
    (CPU, torch.float32, (64, 21, 21), False),
    (CPU, torch.float64, (64, 21, 21), False),
])
def test_route_takes_the_kernel_for_cuda_f32_up_to_32(device, dtype, shape, kernel):
    assert kernel_route(device, dtype, shape) is kernel
    assert kernel_route(str(device), dtype, torch.Size(shape)) is kernel


def test_cpu_solve_takes_the_reference_in_a_sync_span(rng):
    G = _spd(rng, 3, 21)
    run = metrics.RunMetrics()
    before = refined_eigh.launches
    with metrics.bind(run):
        d, V = refined_eigh(torch.from_numpy(G))
    d0, V0 = refined_eigh_reference(torch.from_numpy(G))
    assert torch.equal(d, d0) and torch.equal(V, V0)
    assert run.counters == {"sync.ialm_eigh": 1}
    assert refined_eigh.launches == before


@pytest.mark.parametrize("shape, dtype, match", [
    ((2, 21, 21), torch.float32, "unsupported device"),
    ((2, 33, 33), torch.float32, "1 <= n <= 32"),
    ((2, 21, 20), torch.float32, "1 <= n <= 32"),
    ((0, 21, 21), torch.float32, "matrices"),
    ((2, 21, 21), torch.float64, "unsupported device"),
])
def test_launcher_refuses_what_the_kernel_does_not_take(shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        launch_refined_eigh(torch.zeros(shape, dtype=dtype))


# --- the reference is the parent's chain -----------------------------------

def _parent_refined_eigh(G, steps=2):
    """ops/rpca.py's _refined_eigh before K7, verbatim but for its span."""
    _, V = torch.linalg.eigh(G)
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    tiny = torch.finfo(G.dtype).tiny
    evals = None
    for _ in range(steps):
        R = V.transpose(-1, -2) @ (G @ V)
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        diff = d[..., None, :] - d[..., :, None]
        scale = d.abs().amax(dim=-1, keepdim=True)[..., None] + tiny
        safe = torch.where(diff.abs() > 1e-12 * scale, diff, torch.full_like(diff, float("inf")))
        F = torch.clamp(R / safe, -0.5, 0.5) * (1.0 - eye)
        V, _ = torch.linalg.qr(V @ (eye + F))
        evals = d
    return evals, V


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_is_the_parents_chain_bit_for_bit(rng, dtype):
    G = torch.from_numpy(np.concatenate([_spd(rng, 4, 21), _u8_window_grams(rng, 2, 4000)]))
    G = G.to(dtype)
    d, V = refined_eigh_reference(G)
    d0, V0 = _parent_refined_eigh(G)
    assert NEWTON_STEPS == 2
    assert torch.equal(d, d0) and torch.equal(V, V0)


# --- K7's algorithm, emulated in f32 ----------------------------------------

def _householder_q(U):
    """Q of U's QR as the kernel forms it: LAPACK's reflectors (slarfg),
    Q = H_0 ... H_{n-2} applied backward to I."""
    n = U.shape[0]
    U = U.astype(F32).copy()
    refl = []
    for j in range(n - 1):
        x = U[j:, j].copy()
        xnorm = np.sqrt((x[1:] * x[1:]).sum(dtype=F32), dtype=F32)
        if xnorm == 0:
            refl.append(None)
            continue
        alpha = x[0]
        beta = -np.copysign(np.hypot(alpha, xnorm, dtype=F32), alpha)
        v = x * (F32(1) / (alpha - beta))
        v[0] = 1
        tau = (beta - alpha) / beta
        U[j:, j:] -= (tau * v)[:, None] * (v @ U[j:, j:])[None, :]
        refl.append((v, tau))
    Q = np.eye(n, dtype=F32)
    for j in reversed(range(n - 1)):
        if refl[j] is not None:
            v, tau = refl[j]
            Q[j:, j:] -= (tau * v)[:, None] * (v @ Q[j:, j:])[None, :]
    return Q


def _jacobi(G):
    """The kernel's sweeps: (ascending eigenvalues, V, sweeps)."""
    n = G.shape[0]
    m, steps = jacobi_schedule(n)
    A = np.zeros((m, m), F32)
    A[:n, :n] = np.tril(G) + np.tril(G, -1).T       # the lower triangle, as eigh reads it
    V = np.eye(m, dtype=F32)
    amax = np.abs(A).max()
    scale = F32(2.0 ** -np.frexp(amax)[1]) if amax > 0 else F32(1)
    norm = np.sqrt(((A * scale) ** 2).sum(dtype=F32), dtype=F32)
    offdiag = 1 - np.eye(m, dtype=F32)
    sweeps = 0
    while True:
        off = np.sqrt((((A * scale) * offdiag) ** 2).sum(dtype=F32), dtype=F32)
        if off <= F32(JACOBI_TOL) * norm or sweeps >= MAX_SWEEPS:
            break
        for r, pairs in enumerate(steps):
            part = np.array([jacobi_partner(i, r, m) for i in range(m)])
            alpha, beta, t = np.ones(m, F32), np.zeros(m, F32), np.zeros(m, F32)
            for p, q in pairs:
                apq = A[p, q]
                if apq == 0:
                    continue
                d = A[q, q] - A[p, p]
                two = F32(2) * apq
                tt = F32(np.copysign(1, d)) * two / (np.abs(d) + np.hypot(d, two, dtype=F32))
                c = F32(1) / np.sqrt(F32(1) + tt * tt)
                alpha[[p, q]] = c
                beta[p], beta[q] = -tt * c, tt * c
                t[p] = t[q] = tt
            ai, bi, aj, bj = alpha[:, None], beta[:, None], alpha[None, :], beta[None, :]
            An = (((ai * aj) * A + (bi * bj) * A[part][:, part])
                  + ((ai * bj) * A[:, part] + (bi * aj) * A[part, :]))
            for p, q in pairs:
                apq = A[p, q]
                An[p, p] = A[p, p] - t[p] * apq
                An[q, q] = A[q, q] + t[q] * apq
                An[p, q] = An[q, p] = 0
            V = aj * V + bj * V[:, part]
            A = An.astype(F32)
        sweeps += 1
    d = np.diag(A)[:n]
    order = np.argsort(d, kind="stable")
    return d[order], V[:n, :n][:, order], sweeps


def _k7(G):
    """(d, V, sweeps) of one f32 matrix as K7 computes them."""
    G = np.asarray(G, F32)
    n = G.shape[0]
    d, V, sweeps = _jacobi(G)
    eye = np.eye(n, dtype=F32)
    tiny = np.finfo(F32).tiny
    for _ in range(NEWTON_STEPS):
        R = V.T @ (G @ V)
        d = np.diag(R).copy()
        diff = d[None, :] - d[:, None]
        scale = np.abs(d).max() + tiny
        safe = np.where(np.abs(diff) > F32(1e-12) * scale, diff, F32(np.inf))
        with np.errstate(divide="ignore", invalid="ignore"):
            F = np.where(eye > 0, F32(0), np.clip(R / safe, -0.5, 0.5)).astype(F32)
        V = _householder_q(V @ (eye + F))
    return d, V, sweeps


def _k7_batch(G: torch.Tensor):
    """refined_eigh's contract through the emulation: (d, V) tensors."""
    flat = G.detach().cpu().numpy().reshape(-1, *G.shape[-2:])
    out = [_k7(g) for g in flat]
    d = np.stack([o[0] for o in out]).reshape(*G.shape[:-1])
    V = np.stack([o[1] for o in out]).reshape(G.shape)
    return torch.from_numpy(d).to(G.dtype), torch.from_numpy(V).to(G.dtype)


def _spd(rng, B, n):
    X = rng.standard_normal((B, n, 3 * n))
    return (X @ X.transpose(0, 2, 1)).astype(F32)


def _clustered(rng, B, n):
    out = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = n // 3
        ev = np.r_[np.full(k, 1.0), np.full(k, 1.0 + 1e-6), np.linspace(2.0, 3.0, n - 2 * k)]
        out.append((Q * ev) @ Q.T)
    return np.asarray(out, F32)


def _u8_window_grams(rng, B, P=P_CELL, T=21):
    """Grams M M^T of u8 windows at the cells' crop size: a background of
    60-200, pixel noise, a dark blob moving across a few frames."""
    out = []
    for _ in range(B):
        bg = rng.integers(60, 200, P).astype(np.float64)
        M = bg[None, :] + rng.normal(0.0, rng.uniform(1.0, 4.0), (T, P))
        start = rng.integers(0, P - 2000)
        for t in range(5, 9):
            M[t, start + 200 * t: start + 200 * t + 300] = 20.0
        M = np.clip(np.round(M), 0, 255)
        out.append(M @ M.T)
    return np.asarray(out, F32)


def _warm_trip_grams(rng, B, P=20000, T=21):
    """C = W1 W1^T, W1 = V0^T M, V0 the eigenbasis of the window before a
    small change: nearly diagonal, as the warm solver's trips meet it."""
    out = []
    for g in _u8_window_grams(rng, B, P, T):
        _, V0 = np.linalg.eigh(g.astype(np.float64))
        Q, _ = np.linalg.qr(np.eye(T) + 1e-4 * rng.standard_normal((T, T)))
        V0 = V0 @ Q
        out.append(V0.T @ g.astype(np.float64) @ V0)
    return np.asarray(out, F32)


def _errors(G, d, V):
    """(||V^T V - I||, ||G V - V diag d|| / ||G||, max |d - eigh| / max|eig|)
    against numpy's float64 eigh."""
    G64, V64, d64 = (np.asarray(a, np.float64) for a in (G, V, d))
    n = G.shape[0]
    w = np.linalg.eigvalsh(G64)
    gn = max(np.linalg.norm(G64), 1e-300)
    return (np.linalg.norm(V64.T @ V64 - np.eye(n)),
            np.linalg.norm(G64 @ V64 - V64 * d64) / gn,
            np.abs(np.sort(d64) - w).max() / max(np.abs(w).max(), 1e-300))


@pytest.mark.parametrize("kind, make", [
    ("spd", lambda rng: _spd(rng, 8, 21)),
    ("clustered", lambda rng: _clustered(rng, 8, 21)),
    ("u8_window", lambda rng: _u8_window_grams(rng, 4)),
    ("warm_trip", lambda rng: _warm_trip_grams(rng, 4)),
    ("spd_n32", lambda rng: _spd(rng, 3, 32)),
    ("spd_n7", lambda rng: _spd(rng, 3, 7)),
])
def test_k7_algorithm_is_close_to_f64_eigh(rng, kind, make):
    for G in make(rng):
        d, V, sweeps = _k7(G)
        assert np.isfinite(d).all() and np.isfinite(V).all()
        orth, resid, evals = _errors(G, d, V)
        assert orth <= TOL and resid <= TOL and evals <= TOL, (kind, orth, resid, evals)
        assert 0 < sweeps < MAX_SWEEPS, (kind, sweeps)


def test_k7_algorithm_on_the_all_zero_gram():
    d, V, sweeps = _k7(np.zeros((21, 21), F32))
    assert sweeps == 0
    assert np.array_equal(d, np.zeros(21, F32)) and np.array_equal(V, np.eye(21, dtype=F32))


def test_k7_algorithm_on_rank_one_grams(rng):
    """An exactly rank-1 Gram (a static window's): its 20 null eigenvalues
    differ by f32 rounding alone, far above the Newton step's 1e-12
    cluster test, so F rotates inside the null space by up to 1/2 and the
    steps tilt the top eigenvector.  The parent's chain does the same: its
    residual reaches 3.4e-3 on 300 such Grams, the kernel's algorithm's
    2.0e-3, the median of either 4e-6.  V stays orthonormal and the
    eigenvalues exact; the Jacobi sweeps alone meet TOL."""
    resid = []
    for _ in range(40):
        v = rng.standard_normal(21) * rng.uniform(1.0, 1e4)
        G = np.outer(v, v).astype(F32)
        d, V, sweeps = _k7(G)
        orth, r, evals = _errors(G, d, V)
        assert np.isfinite(V).all() and orth <= TOL and evals <= TOL and sweeps <= 2
        dj, Vj, _ = _jacobi(G)
        assert _errors(G, dj, Vj)[1] <= TOL
        resid.append(r)
    assert np.median(resid) <= TOL and max(resid) <= 1e-2


def test_k7_algorithm_keeps_the_solvers_iterations_and_motion(monkeypatch):
    """The warm IALM solve of a batch of the synthetic scene, with the
    refined eigh emulated as K7 computes it, against the plain chain:
    iterations within 1 a window, motion within 2 u8."""
    video = make_video(seed=3, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
    gray = torch.from_numpy(video.frames[:42, 100:140, 200:248, 1].copy()).reshape(2, 21, 40, 48)
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=2)
    motion0, iters0 = rpca.rpca_motion_window_batched(gray, cfg)
    monkeypatch.setattr(ialm_trip, "refined_eigh", _k7_batch)     # the seed's and each trip's
    motion, iters = rpca.rpca_motion_window_batched(gray, cfg)
    assert int((iters - iters0).abs().max()) <= 1, (iters, iters0)
    assert int((motion.int() - motion0.int()).abs().max()) <= 2
    assert int(iters0.min()) > 1


def test_kernel_limits_match_the_source():
    text = (build.CSRC / "refined_eigh.cu").read_text()
    assert f"constexpr int kMaxN = {MAX_N};" in text
