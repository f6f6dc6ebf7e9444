"""RPCA background subtraction by inexact augmented Lagrange multipliers.

Counterpart of swiftwatcher_tpu/ops/rpca.py: `ialm_rpca_batched` (warm
and cold start, the pipeline's solver) and the single-window `ialm_rpca`
with its two SVD methods, "device" (the row-space SVD below) and
"host_svd" (numpy's LAPACK SVD of a host copy, the validation oracle the
device solver is held to).  The SVD of each tall-skinny
iterate (T = 21 frames x P pixels) is taken through its row space: a T x T
eigendecomposition refined by Newton steps (ops/refined_eigh.py: the
kernel K7 on a CUDA f32 solve, else torch.linalg.eigh and qr), then a
one-sided polish round that restores relative accuracy on the small
singular values.  The products are `torch.matmul`.

The batched solver's loop makes one call a trip, to `ialm_trip`
(ops/ialm_trip.py), which updates A, E and Y in place and picks its own
route: K8's two kernels on a warm CUDA f32 solve, else the plain chain.  The
warm-basis solver (the shipped default) carries the eigenbasis across
trips, seeded there by `seed_basis`; the cold-start solver forms each
iterate's T x T Gram and takes its basis from a fresh eigh, the Gram from
the fused front kernel K6 (ops/ialm_front.py) where fused_front is set.

Quirks of the reference kept on purpose:
  * the svp length quirk: every iteration keeps all T singular values, so
    `S - 1/mu` may go negative;
  * "norm_two" is the Frobenius norm of the raveled matrix;
  * norms are floored at 1e-12 so an all-zero window converges at once;
  * motion is the negated sparse part, clipped to [0, 255] before the
    uint8 cast.

The dynamic loop reads `any(active)` back to the host once per iteration,
in a `sync.ialm_stop` span of the run's metrics (utils/metrics.py); on a
CUDA f32 solve that is the trip's only read, and K7 runs in an `ialm_eigh`
span, while elsewhere each `eigh`, which synchronises the card with the
host, runs in a `sync.ialm_eigh` span.  A K8 trip is an `ialm_trip` span.
The solve is the `ialm_solve` span.

Sequence parallelism (parallel/mesh.py): with a `group`, X is one block of
the pixel axis and the solve runs on every rank of the group together; the
T x T Grams and the norms are its only cross-rank quantities, summed (and
for norm_inf maxed) over the group at the JAX package's psum/pmax sites.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..utils.metrics import span
from .ialm_trip import ialm_trip, seed_basis
from .refined_eigh import refined_eigh

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
}


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _row_space_svd(M: torch.Tensor, polish_steps: int = 2):
    """(S, V) of tall-skinny M (..., P, T) through its row space: the Gram's
    refined eigenbasis, then one-sided polish steps (rotate the columns,
    W = M V, and re-diagonalise W^T W) that restore full relative accuracy
    on the small singular values, which a plain Gram eigh loses in f32."""
    _, V = refined_eigh(_t(M) @ M)
    S2 = None
    for _ in range(polish_steps):
        W = M @ V
        d, V1 = refined_eigh(_t(W) @ W)
        V = V @ V1
        S2 = d
    return torch.sqrt(torch.clamp(S2, min=0.0)), V


def _shrunk_lowrank(M: torch.Tensor, shrink: torch.Tensor) -> torch.Tensor:
    """A = U diag(S - shrink) V^T for M = U S V^T, as M V diag(f(S)/S) V^T.

    All T components are kept (the svp quirk), so the row-space
    reconstruction is exact up to rounding.  f(S)/S divides by S floored
    at eps * max(S) + tiny: a null component then keeps its bounded
    magnitude |S - shrink| instead of overflowing."""
    S, V = _row_space_svd(M)
    fi = torch.finfo(M.dtype)
    floor = fi.eps * S.amax(dim=-1, keepdim=True) + fi.tiny
    ratio = (S - shrink[..., None]) / torch.maximum(S, floor)
    return ((M @ V) * ratio[..., None, :]) @ _t(V)


def _host_svd_lowrank(M: torch.Tensor, shrink: torch.Tensor) -> torch.Tensor:
    """A = U diag(S - shrink) V^T from numpy's LAPACK SVD of a host copy of M.

    The validation oracle, as the JAX package's host callback is: the
    reference's own LAPACK arithmetic, against which the device solver is
    held.  It is not a fallback of the pipeline, which never calls it."""
    import numpy as np

    m = M.detach().cpu().numpy()
    s = np.asarray(shrink.detach().cpu().numpy(), m.dtype)
    u, sv, vt = np.linalg.svd(m, full_matrices=False)
    return torch.from_numpy(((u * (sv - s)) @ vt).astype(m.dtype)).to(M.device)


def ialm_rpca(
    X: torch.Tensor,
    lmbda: float = 0.01,
    tol: float = 0.001,
    max_iter: int = 100,
    rho: float = 1.5,
    mu_cap: float = 1e7,
    method: str = "device",
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Decompose one window X (P pixels x T frames, float) into low-rank A
    plus sparse E, step for step the reference's IALM
    (image_filtering.py:256-301, quirks as in the module docstring, norms
    unfloored as there).  Returns (A, E, iterations).

    method: "device" (the row-space SVD, on X's device) or "host_svd"
    (numpy's LAPACK SVD each iteration: the oracle).  The loop reads its
    stopping test back to the host once per iteration."""
    if method not in ("device", "host_svd"):
        raise ValueError(f"method must be 'device' or 'host_svd', got {method!r}")
    lowrank = _host_svd_lowrank if method == "host_svd" else _shrunk_lowrank
    frob = torch.linalg.norm(X)                     # ||X||_F
    norm_inf = X.abs().amax() / lmbda
    Y = X / torch.maximum(frob, norm_inf)
    mu = 1.25 / frob
    A = E = torch.zeros_like(X)
    itr, err = 0, float("inf")
    while err >= tol and itr < max_iter:
        inv_mu = 1.0 / mu
        Eraw = X - A + inv_mu * Y
        E = torch.clamp(Eraw - lmbda * inv_mu, min=0.0) + torch.clamp(
            Eraw + lmbda * inv_mu, max=0.0)
        M = X - E + inv_mu * Y
        A = lowrank(M, inv_mu)
        Z = X - A - E
        Y = Y + mu * Z
        mu = torch.minimum(mu * rho, mu * mu_cap)
        err = float(torch.linalg.norm(Z) / frob)
        itr += 1
    return A, E, itr


def ialm_rpca_batched(
    X: torch.Tensor,
    lmbda: float = 0.01,
    tol: float = 0.001,
    max_iter: int = 100,
    rho: float = 1.5,
    mu_cap: float = 1e7,
    fused_front: bool = False,
    warm_basis: bool = False,
    x_store_dtype: Optional[str] = None,
    store_y_dtype: Optional[str] = None,
    store_ae_dtype: Optional[str] = None,
    fixed_iters: int = 0,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched IALM over row-convention X (B, T, P).

    Converged windows are frozen while the rest finish.  Returns (A, E,
    iters): A and E are (B, T, P) in X's dtype, iters is (B,) int32.

    warm_basis carries the row-space eigenbasis across iterations (seeded
    from one Gram before the loop); without it every iteration forms the
    Gram of its iterate M and starts the polish from that Gram's eigh.
    fused_front (cold start only) takes E, M and that Gram from K6.  Each
    trip is one `ialm_trip`, which picks K8 or the plain chain itself.

    x_store_dtype holds X between uses ('uint8' is lossless for uint8-origin
    windows); store_y_dtype / store_ae_dtype round the loop-carried Y and
    (A, E) to that dtype between iterations (lossy, PARITY deviation 8).
    fixed_iters > 0 runs exactly that many iterations with no stopping test
    and no freeze masks.

    group: the counterpart of the JAX package's axis_name, an object with
    sum(t) and max(t) over the ranks that hold the other pixel blocks of X
    (parallel.mesh.AxisGroup); None solves X alone.  Every rank of the
    group sees the same reduced norms, so all take the same iterations."""
    dtype = X.dtype

    def allsum(v):
        return group.sum(v) if group is not None else v

    def allmax(v):
        return group.max(v) if group is not None else v

    frob = torch.sqrt(allsum((X * X).sum(dim=(-2, -1)))).clamp(min=1e-12)   # (B,)
    norm_inf = allmax(X.abs().amax(dim=(-2, -1))) / lmbda
    dual = torch.maximum(frob, norm_inf)
    Y0 = X / dual[..., None, None]
    mu0 = 1.25 / frob
    Xs = X.to(_DTYPES.get(x_store_dtype, dtype))
    V = seed_basis(X, Y0, mu0, warm_basis, allsum)
    # the trip updates A, E and Y in place, each in its storage dtype
    A = torch.zeros_like(X, dtype=_DTYPES.get(store_ae_dtype, dtype))
    E = torch.zeros_like(A)
    Y = Y0.to(_DTYPES.get(store_y_dtype, dtype))
    mu = mu0
    B = X.shape[0]
    itr = torch.zeros((B,), dtype=torch.int32, device=X.device)
    err = torch.full((B,), float("inf"), dtype=dtype, device=X.device)
    trips = 0
    while trips < fixed_iters or fixed_iters <= 0:
        active = None
        if fixed_iters <= 0:
            active = (err >= tol) & (itr < max_iter)                 # (B,)
            with span("sync.ialm_stop"):
                done = not bool(active.any())
            if done:
                break
        mu_new, Vn, zz = ialm_trip(Xs, A, E, Y, mu, V, active, lmbda, rho, mu_cap, allsum,
                                   warm_basis, fused_front)
        err_new = torch.sqrt(allsum(zz)) / frob
        trips += 1
        if active is None:
            mu, V = mu_new, Vn
            continue
        mu = torch.where(active, mu_new, mu)
        V = torch.where(active[..., None, None], Vn, V)
        itr = itr + active.to(torch.int32)
        err = torch.where(active, err_new, err)
    if fixed_iters > 0:
        itr = torch.full((B,), fixed_iters, dtype=torch.int32, device=X.device)
    return A.to(dtype), E.to(dtype), itr


def ialm_gates_and_kwargs(
    cfg: PipelineConfig, dtype: torch.dtype, device: torch.device
) -> dict:
    """ialm_rpca_batched keyword arguments from a PipelineConfig, for a
    solve in `dtype` on `device`.

    The JAX package's gate (swiftwatcher_tpu/ops/rpca.py:472-508) with the
    card in the TPU's place: the fused front K6 runs on the cold-start
    solver, on a CUDA device, in f32.  Unlike the Pallas kernel, K6 reads X
    as u8, so X stays u8 on the fused path too (a lossless hold: the same
    values either way)."""
    warm = cfg.rpca_warm_basis
    fused = (
        cfg.use_pallas_rpca
        and not warm
        and torch.device(device).type == "cuda"
        and dtype == torch.float32
    )
    state_sd = "bfloat16" if (cfg.rpca_state_bf16 and dtype == torch.float32) else None
    return dict(
        lmbda=cfg.rpca_lambda,
        tol=cfg.rpca_tol,
        max_iter=cfg.rpca_max_iter,
        rho=cfg.rpca_rho,
        mu_cap=cfg.rpca_mu_cap,
        fused_front=fused,
        warm_basis=warm,
        x_store_dtype="uint8" if cfg.rpca_store_x_u8 else None,
        store_y_dtype=state_sd,
        store_ae_dtype=state_sd,
        fixed_iters=cfg.rpca_fixed_iters,
    )


def motion_from_E(E: torch.Tensor, P: int) -> torch.Tensor:
    """Sparse part -> uint8 motion: clip(-E, 0, 255) on the first P pixels."""
    return torch.clamp(-E[..., :P], 0.0, 255.0).to(torch.uint8)


def rpca_motion_window_batched(
    gray_windows: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, W) uint8 -> ((B, T, H, W) uint8 motion, (B,) int32 iters)."""
    B, T, H, W = gray_windows.shape
    dtype = _DTYPES[cfg.rpca_dtype]
    P = H * W
    X = gray_windows.reshape(B, T, P).to(dtype)
    with span("ialm_solve"):
        _, E, iters = ialm_rpca_batched(X, **ialm_gates_and_kwargs(cfg, dtype, X.device))
    return motion_from_E(E, P).reshape(B, T, H, W), iters


def rpca_motion_window(
    gray_window: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W) uint8 -> ((T, H, W) uint8 motion, () int32 iters): the
    batched solver on a batch of one, so both share one arithmetic."""
    motion, iters = rpca_motion_window_batched(gray_window[None], cfg)
    return motion[0], iters[0]
