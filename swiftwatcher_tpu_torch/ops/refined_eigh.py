"""K7: small symmetric eigendecompositions with Newton refinement.

`refined_eigh(G)` takes a (..., n, n) symmetric batch and returns (d, V),
the refined eigenvalues and eigenvectors (in columns) of each matrix: an
eigendecomposition, then Newton steps V <- orth(V (I + F)) with
F_ij = (V^T G V)_ij / (d_j - d_i), clamped to [-1/2, 1/2] and skipped
for clustered eigenvalues; d is the diagonal of the last step's V^T G V.
The IALM solver (ops/rpca.py) takes its row-space bases from it, once a
trip.

Route (`kernel_route`, from device, dtype and shape alone): a CUDA f32
batch of n <= 32 launches csrc/refined_eigh.cu, one block a matrix, with
no host read; anything else (the CPU, f64, larger n) runs
`refined_eigh_reference`, the plain chain, whose `torch.linalg.eigh`
synchronises the card with the host.  The kernel runs the reference's
Newton steps with the reference's formulas after a Jacobi
eigendecomposition in place of eigh, with Householder QR in place of
torch.linalg.qr.

The two routes may differ in the sign of a column of V and in the order of
the eigenvalues (the kernel sorts them ascending, as eigh does, but two
near-equal ones may come out swapped), and neither changes the solver's
results: every use in ops/rpca.py has the form V diag(f(d)) V^T, where a
column's sign cancels and a column travels with its own eigenvalue, or
V0 V1 followed by (V0 V1) diag(.) V1^T, where V1's column signs cancel in
the same way.

The kernel's Jacobi sweeps pair the indices in round-robin order
(`jacobi_schedule` mirrors it) and stop once the off-diagonal Frobenius
norm is at most JACOBI_TOL ||G||_F, after MAX_SWEEPS at most; it also
returns the sweeps each matrix took (`launch_refined_eigh`), which only
tests and chip_smoke.py read.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .. import build
from ..utils.metrics import span

MAX_N = 32
NEWTON_STEPS = 2
JACOBI_TOL = 4 * float(torch.finfo(torch.float32).eps)
MAX_SWEEPS = 16


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def refined_eigh_reference(G: torch.Tensor, steps: int = NEWTON_STEPS):
    """eigh with first-order Newton refinement: V <- orth(V (I + F)),
    F_ij = (V^T G V)_ij / (d_j - d_i), clamped, skipped for clustered
    eigenvalues."""
    with span("sync.ialm_eigh"):
        _, V = torch.linalg.eigh(G)
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    tiny = torch.finfo(G.dtype).tiny
    evals = None
    for _ in range(steps):
        R = _t(V) @ (G @ V)
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        diff = d[..., None, :] - d[..., :, None]
        scale = d.abs().amax(dim=-1, keepdim=True)[..., None] + tiny
        safe = torch.where(diff.abs() > 1e-12 * scale, diff, torch.full_like(diff, float("inf")))
        F = torch.clamp(R / safe, -0.5, 0.5) * (1.0 - eye)
        V, _ = torch.linalg.qr(V @ (eye + F))
        evals = d
    return evals, V


def jacobi_partner(i: int, r: int, m: int) -> int:
    """The kernel's round-robin schedule on m (even) indices: the index
    that i meets in step r.  m - 1 stays put and meets r; the others sit on
    a circle, where (r + k) mod (m - 1) meets (r - k) mod (m - 1)."""
    last = m - 1
    if i == last:
        return r
    if i == r:
        return last
    return (2 * r - i) % last


def jacobi_schedule(n: int) -> Tuple[int, List[List[Tuple[int, int]]]]:
    """(m, steps): n padded to even m, and each of a sweep's m - 1 steps as
    its m / 2 pairs (p, q), p < q, in the order of p.  A pair that holds
    the padding index n (odd n) is never rotated."""
    m = n + (n & 1)
    steps = []
    for r in range(m - 1):
        pairs = {tuple(sorted((i, jacobi_partner(i, r, m)))) for i in range(m)}
        steps.append(sorted(pairs))
    return m, steps


def kernel_route(device: torch.device, dtype: torch.dtype, shape) -> bool:
    """Whether a (..., n, n) batch of `dtype` on `device` takes the kernel:
    CUDA, f32, square, 1 <= n <= MAX_N and at least one matrix."""
    shape = tuple(shape)
    return (
        torch.device(device).type == "cuda"
        and dtype == torch.float32
        and len(shape) >= 2
        and shape[-1] == shape[-2]
        and 1 <= shape[-1] <= MAX_N
        and math.prod(shape[:-2]) >= 1
    )


def refined_eigh(G: torch.Tensor):
    """(d, V) of the symmetric (..., n, n) batch G: the kernel where
    kernel_route picks it, in an `ialm_eigh` span; else the plain chain."""
    if not kernel_route(G.device, G.dtype, G.shape):
        return refined_eigh_reference(G)
    with span("ialm_eigh"):
        d, V, _ = launch_refined_eigh(G.contiguous())
    refined_eigh.launches += 1
    return d, V


refined_eigh.launches = 0


def launch_refined_eigh(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of csrc/refined_eigh.cu on the CUDA f32 batch G (...,
    n, n): (d (..., n), V (..., n, n), sweeps (...) int32)."""
    *lead, n, n2 = G.shape
    if n != n2 or not 1 <= n <= MAX_N:
        raise ValueError(f"refined_eigh: want (..., n, n) with 1 <= n <= {MAX_N}, "
                         f"got {tuple(G.shape)}")
    B = math.prod(lead)
    if not 1 <= B <= 2**31 - 1:
        raise ValueError(f"refined_eigh: want 1 to 2**31 - 1 matrices, got {B}")
    G3 = G.reshape(B, n, n)
    build.check_operand("refined_eigh", G3, torch.float32)
    d = torch.empty((B, n), dtype=torch.float32, device=G.device)
    V = torch.empty((B, n, n), dtype=torch.float32, device=G.device)
    sweeps = torch.empty((B,), dtype=torch.int32, device=G.device)
    build.launch(
        "refined_eigh", "swt_refined_eigh", G.device,
        G3.data_ptr(), d.data_ptr(), V.data_ptr(), sweeps.data_ptr(),
        B, n, NEWTON_STEPS, JACOBI_TOL, MAX_SWEEPS,
    )
    return d.reshape(*lead, n), V.reshape(*lead, n, n), sweeps.reshape(lead)
