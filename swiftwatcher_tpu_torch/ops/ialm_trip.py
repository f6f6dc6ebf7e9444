"""The batched IALM solver's trip, and K8, its warm trip in two kernels.

One trip of ops/rpca.py's batched solver, per window of a (B, T, P) state
with its scalar mu and basis V0 (T x T):

    E, M  = the front of A, Y and X (ops/ialm_front.py:front_chain)
    W1    = V0^T M;   C = W1 W1^T (summed over the pixels, and the group)
    d, V1 = refined_eigh(C);   Vn = V0 V1;   S = sqrt(max(d, 0))
    Q     = (Vn diag((S - 1/mu) / max(S, floor))) V1^T
    Aupd  = Q W1;   Z = X - Aupd - E;   Ynew = Y + mu Z;   mu <- min(mu rho, mu mu_cap)

A warm trip carries V0 from the last; the solver seeds it from M0 = X +
Y0 / mu0 (`seed_basis`).  A cold trip takes V0 from the refined eigh of
M M^T, with E, M and that Gram from K6 where the solver's fused_front is
set (ops/ialm_front.py).  Every refined eigh of a batched solve is here.

`ialm_trip` is the solver's only trip: it updates A, E and Y in place, each
rounded to its storage dtype, for the windows whose `active` flag is set; an
inactive window keeps them bit for bit.  It picks its route from the
tensors and `warm`.  A warm CUDA f32 solve with T <= 32 whose X is held u8
or f32 and A, E, Y all bf16 or all f32 (`kernel_route`) runs
csrc/ialm_trip.cu: K8a reads X, A and Y once and returns C, the T x T work
between runs in PyTorch (K7 on C, then `rotation`), and K8b reads them
again and writes A, E and Y with each window's sum of Z^2.  Everywhere else
(CPU, f64, T > 32, the cold start) the trip is the plain chain,
`ialm_trip_reference`, stored into A, E and Y through `torch.where`.  The
kernels' E and their stores' rounding are the plain chain's bit for bit;
W1, C, Aupd and the sum of Z^2 sum in orders of their own (per column, then
the blocks' partials in a fixed order: the trips repeat bit for bit from
run to run), held to the chain within tolerances by
tests/test_torch_ialm_trip.py and chip_smoke.py phase 20.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import build
from ..utils.metrics import span
from .ialm_front import front_chain, ialm_front, ialm_front_reference
from .refined_eigh import refined_eigh

KERNEL_THREADS = 256
CHUNK = 2 * KERNEL_THREADS   # pixel columns per chunk of the kernels (2 a thread)
MAX_T = 32
# Blocks an SM holds of either kernel (their launch bounds); the grid fills
# the card's resident slots once.
_BLOCKS_PER_SM = 2
# How close the kernels come to the plain chain on one trip's state
# (tests/test_torch_ialm_trip.py, chip_smoke.py phase 20): E and its store
# bit-equal; C within C_RTOL of max|C| and each window's sum of Z^2 within
# ZZ_RTOL of it (another summation order than a GEMM's); A and Y rounded to
# bf16 within one bf16 step at their largest magnitude, STATE_RTOL of it.
C_RTOL = 1e-3
ZZ_RTOL = 1e-3
STATE_RTOL = 2.0 ** -7


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _same(v: torch.Tensor) -> torch.Tensor:
    return v


def kernel_route(device: torch.device, dtype: torch.dtype, shape, x_dtype: torch.dtype,
                 state_dtype: torch.dtype, y_dtype: torch.dtype, warm_basis: bool) -> bool:
    """Whether a solve in `dtype` on `device` over (B, T, P) `shape`, with X
    held as x_dtype, A and E as state_dtype and Y as y_dtype, runs its trips
    on K8: a warm CUDA f32 solve, 1 <= T <= 32, 1 <= B <= 65535, X u8 or
    f32, and A, E and Y all bf16 or all f32."""
    B, T, P = shape
    return (
        warm_basis
        and torch.device(device).type == "cuda"
        and dtype == torch.float32
        and 1 <= B <= 65535 and 1 <= T <= MAX_T and P >= 1
        and x_dtype in (torch.uint8, torch.float32)
        and state_dtype in (torch.bfloat16, torch.float32)
        and y_dtype == state_dtype
    )


def seed_basis(X, Y0, mu0, warm: bool, allsum: Callable = _same) -> torch.Tensor:
    """V0 of the first trip, (B, T, T) in X's dtype: warm, the refined
    eigenbasis of M0 M0^T with M0 = X + Y0 / mu0 (A0 = E0 = 0); cold, the
    identity (a cold trip forms its own)."""
    B, T = X.shape[0], X.shape[1]
    if not warm:
        return torch.eye(T, dtype=X.dtype, device=X.device).expand(B, T, T)
    M0 = X + (1.0 / mu0)[..., None, None] * Y0
    return refined_eigh(allsum(M0 @ _t(M0)))[1]


def rotation(C: torch.Tensor, V0: torch.Tensor, mu: torch.Tensor):
    """(Q, Vn) of the polish round from the rotated columns' Gram C:
    A = Vn diag(ratio) Vn^T M = [(Vn diag ratio) V1^T] (V0^T M) = Q W1."""
    d, V1 = refined_eigh(C)
    S = torch.sqrt(torch.clamp(d, min=0.0))
    Vn = V0 @ V1
    fi = torch.finfo(C.dtype)
    floor = fi.eps * S.amax(dim=-1, keepdim=True) + fi.tiny
    ratio = (S - (1.0 / mu)[..., None]) / torch.maximum(S, floor)
    return (Vn * ratio[..., None, :]) @ _t(V1), Vn


def ialm_trip_reference(Xs, A_s, Y_s, mu, V0, lmbda: float, rho: float, mu_cap: float,
                        allsum: Callable = _same, front: Optional[Callable] = None):
    """One trip as the plain chain: (Aupd, Eupd, Ynew, mu_new, Vn, Z) in
    mu's dtype, from X, A and Y as the solver holds them.  Warm where
    `front` is None; cold, E, M and G come from `front` (ialm_front or
    ialm_front_reference) and V0 is the refined eigenbasis of G."""
    if front is None:
        E, M = front_chain(Xs, A_s, Y_s, 1.0 / mu, lmbda)
    else:
        E, M, G = front(Xs, A_s, Y_s, 1.0 / mu, lmbda)
        V0 = refined_eigh(allsum(G))[1]
    W1 = _t(V0) @ M
    Q, Vn = rotation(allsum(W1 @ _t(W1)), V0, mu)
    Aupd = Q @ W1
    Z = Xs.to(mu.dtype) - Aupd - E
    Ynew = Y_s.to(mu.dtype) + mu[..., None, None] * Z
    return Aupd, E, Ynew, torch.minimum(mu * rho, mu * mu_cap), Vn, Z


def ialm_trip(Xs, A, E, Y, mu, V0, active: Optional[torch.Tensor], lmbda: float, rho: float,
              mu_cap: float, allsum: Callable = _same, warm: bool = True,
              fused_front: bool = False):
    """One trip of the batched solver: A, E and Y updated in place for the
    windows whose `active` flag is set (all, where active is None), each
    rounded to its own dtype.  Returns (mu_new, Vn, zz), zz each window's
    sum of Z^2 over its pixels; an inactive window's are for the caller to
    discard (K8 leaves its zz 0).  On K8 (kernel_route) the trip runs in
    an `ialm_trip` span and counts in `ialm_trip.launches`."""
    if not kernel_route(Xs.device, mu.dtype, Xs.shape, Xs.dtype, A.dtype, Y.dtype, warm):
        front = None if warm else ialm_front if fused_front else ialm_front_reference
        Aupd, Eupd, Ynew, mu_new, Vn, Z = ialm_trip_reference(
            Xs, A, Y, mu, V0, lmbda, rho, mu_cap, allsum, front)
        for state, new in ((A, Aupd), (E, Eupd), (Y, Ynew)):
            new = new.to(state.dtype)
            if active is not None:
                new = torch.where(active[..., None, None], new, state)
            state.copy_(new)
        return mu_new, Vn, (Z * Z).sum(dim=(-2, -1))
    V0 = V0.contiguous()
    inv_mu = 1.0 / mu
    with span("ialm_trip"):
        C = launch_front(Xs, A, Y, inv_mu, V0, active, lmbda)
        Q, Vn = rotation(allsum(C), V0, mu)
        zz = launch_back(Xs, A, E, Y, inv_mu, mu, V0, Q, active, lmbda)
    ialm_trip.launches += 1
    return torch.minimum(mu * rho, mu * mu_cap), Vn, zz


ialm_trip.launches = 0


def blocks_per_window(B: int, P: int, sms: int) -> int:
    """Grid blocks a window: the card's resident slots shared among the B
    windows (one wave), at least 1, at most a block a chunk."""
    return max(1, min(-(-P // CHUNK), sms * _BLOCKS_PER_SM // B))


def _check(X, A, Y, E, vectors, squares, active) -> Tuple[int, int, int]:
    """Raise unless X (u8 or f32), A, Y and E (if given; bf16 or f32, all
    alike) are contiguous (B, T, P) CUDA tensors, each of `vectors` a
    contiguous (B,) f32 and each of `squares` a (B, T, T) f32 on X's device,
    and active None or a (B,) bool; returns (B, T, P)."""
    if X.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"ialm_trip: X must be float32 or uint8, got {X.dtype}")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ialm_trip: A must be float32 or bfloat16, got {A.dtype}")
    build.check_operand("ialm_trip", X, X.dtype)
    for t in (A, Y) if E is None else (A, Y, E):
        build.check_operand("ialm_trip", t, A.dtype, like=X)
    B, T, P = X.shape
    if not (1 <= B <= 65535 and 1 <= T <= MAX_T):
        raise ValueError(f"ialm_trip: want 1 <= B <= 65535, 1 <= T <= {MAX_T}; "
                         f"got {tuple(X.shape)}")
    wants = [(name, t, (B,), torch.float32) for name, t in vectors]
    wants += [(name, t, (B, T, T), torch.float32) for name, t in squares]
    if active is not None:
        wants.append(("active", active, (B,), torch.bool))
    for name, t, shape, dtype in wants:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != X.device
                or not t.is_contiguous()):
            raise ValueError(f"ialm_trip: {name} must be a contiguous {shape} {dtype} "
                             f"tensor on {X.device}")
    return B, T, P


def _blocks(X: torch.Tensor) -> int:
    B, _, P = X.shape
    return blocks_per_window(B, P, torch.cuda.get_device_properties(X.device)
                             .multi_processor_count)


def _flags(X, A) -> Tuple[int, int]:
    return int(X.dtype == torch.uint8), int(A.dtype == torch.bfloat16)


def launch_front(X, A, Y, inv_mu, V0, active, lmbda: float) -> torch.Tensor:
    """K8a on CUDA operands: C = W1 W1^T, (B, T, T) f32 (zero for an
    inactive window)."""
    B, T, P = _check(X, A, Y, None, [("inv_mu", inv_mu)], [("V0", V0)], active)
    n_blocks = _blocks(X)
    C = torch.empty((B, T, T), dtype=torch.float32, device=X.device)
    part = torch.empty((B, n_blocks, T * (T + 1) // 2), dtype=torch.float32,
                       device=X.device)
    build.launch(
        "ialm_trip", "swt_ialm_trip_front", X.device,
        X.data_ptr(), A.data_ptr(), Y.data_ptr(), inv_mu.data_ptr(), V0.data_ptr(),
        0 if active is None else active.data_ptr(), part.data_ptr(), C.data_ptr(),
        B, T, P, n_blocks, *_flags(X, A), float(lmbda),
    )
    return C


def launch_back(X, A, E, Y, inv_mu, mu, V0, Q, active, lmbda: float) -> torch.Tensor:
    """K8b on CUDA operands: A, E and Y written in place for the active
    windows; returns zz, (B,) f32."""
    B, T, P = _check(X, A, Y, E, [("inv_mu", inv_mu), ("mu", mu)], [("V0", V0), ("Q", Q)],
                     active)
    n_blocks = _blocks(X)
    zz = torch.empty((B,), dtype=torch.float32, device=X.device)
    part = torch.empty((B, n_blocks), dtype=torch.float32, device=X.device)
    build.launch(
        "ialm_trip", "swt_ialm_trip_back", X.device,
        X.data_ptr(), A.data_ptr(), E.data_ptr(), Y.data_ptr(), inv_mu.data_ptr(),
        mu.data_ptr(), V0.data_ptr(), Q.data_ptr(),
        0 if active is None else active.data_ptr(), part.data_ptr(), zz.data_ptr(),
        B, T, P, n_blocks, *_flags(X, A), float(lmbda),
    )
    return zz
