"""IALM robust PCA, batched over windows (image_filtering.py:256-301).

X is (B, T, P): each window's T frames as rows.  Step for step the
original's loop, with its quirks: the dual scale uses the Frobenius norm
(the "norm_two" of the raveled matrix), every iteration keeps all T
singular values shrunk by 1/mu (the svp length quirk), and the loop stops
after the iteration whose residual falls below tol, or at max_iter.  A
window stops updating once it has stopped; the others go on.

The thin SVD of each iterate comes from the eigendecomposition of its T x T
Gram matrix: A = V diag((S - 1/mu) / S) V^T M.  In float64 that loses
nothing the motion's uint8 rounding would keep.

`precision="tf32"` is the control, one precision step below the float32
products with TF32 off that the configuration states: the same steps in
float32 with every matrix product's operands rounded to TF32 (10 mantissa
bits, to nearest even), as a tensor-core TF32 product rounds them, on any
device.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's 10 mantissa bits, ties to even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    keep = (i >> 13) & 1
    i = ((i + 0xFFF + keep) >> 13) << 13
    return i.to(torch.int32).view(torch.float32).reshape(x.shape)


def ialm(X: torch.Tensor, lmbda: float, tol: float, max_iter: int, rho: float,
         mu_cap: float, precision: str = "float64"):
    """(E (B, T, P) in the solve's dtype, iterations (B,) int64)."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64

    def mm(a, b):
        return tf32_round(a) @ tf32_round(b) if tf32 else a @ b

    X = X.to(dtype)
    B = X.shape[0]
    # an all-zero window would divide by zero in the original; floor it
    frob = torch.sqrt((X * X).sum(dim=(1, 2))).clamp(min=1e-12)
    dual = torch.maximum(frob, X.abs().amax(dim=(1, 2)) / lmbda)
    Y = X / dual[:, None, None]
    mu = 1.25 / frob
    A = torch.zeros_like(X)
    E = torch.zeros_like(X)
    iters = torch.zeros(B, dtype=torch.int64, device=X.device)
    active = torch.ones(B, dtype=torch.bool, device=X.device)
    fi = torch.finfo(dtype)
    while bool(active.any()):
        inv = (1.0 / mu)[:, None, None]
        Eraw = X - A + inv * Y
        E_new = torch.clamp(Eraw - lmbda * inv, min=0.0) + torch.clamp(Eraw + lmbda * inv, max=0.0)
        M = X - E_new + inv * Y
        w, V = torch.linalg.eigh(mm(M, M.transpose(1, 2)))
        S = torch.sqrt(torch.clamp(w, min=0.0))
        floor = fi.eps * S.amax(dim=1, keepdim=True) + fi.tiny
        ratio = (S - inv[:, :, 0]) / torch.maximum(S, floor)
        A_new = mm(mm(V * ratio[:, None, :], V.transpose(1, 2)), M)
        Z = X - A_new - E_new
        Y_new = Y + mu[:, None, None] * Z
        err = torch.sqrt((Z * Z).sum(dim=(1, 2))) / frob
        keep = active[:, None, None]
        A = torch.where(keep, A_new, A)
        E = torch.where(keep, E_new, E)
        Y = torch.where(keep, Y_new, Y)
        mu = torch.where(active, torch.minimum(mu * rho, mu * mu_cap), mu)
        iters = iters + active.to(torch.int64)
        active = active & (err >= tol) & (iters < max_iter)
    return E, iters
