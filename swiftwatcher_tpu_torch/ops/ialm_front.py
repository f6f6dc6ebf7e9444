"""K6: the front half of a cold-start IALM iteration in one pass.

Counterpart of swiftwatcher_tpu/ops/pallas/ialm_front.py:ialm_front.  Per
window of a (B, T, P) state with its scalar inv_mu:

    Eraw = X - A + inv_mu * Y
    E    = max(Eraw - lmbda*inv_mu, 0) + min(Eraw + lmbda*inv_mu, 0)
    M    = X - E + inv_mu * Y
    G    = M M^T        (T x T, summed over the P pixels)

The operands come as the solver holds them (X u8 or float, A and Y bf16 or
float) and are widened to inv_mu's dtype first.  On a CUDA tensor
`ialm_front` launches csrc/ialm_front.cu (f32 only), whose E and M are
bit-equal to the plain version and whose G differs by summation order; on
a CPU tensor it runs `ialm_front_reference`.  Unlike the TPU kernel it takes
any P: no zero padding.  The kernel's Gram is register-blocked over 4 x 4
blocks of row pairs (`gram_blocks`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import build

KERNEL_THREADS = 256
CHUNK = 2 * KERNEL_THREADS   # pixel columns per chunk of the kernel (2 a thread)
MAX_T = 32
# Blocks per SM that the kernel's grid aims for: as many as reside at
# T = 21 (the M tile takes about 49 KB of shared memory).
_BLOCKS_PER_SM = 4


def front_chain(
    X: torch.Tensor, A: torch.Tensor, Y: torch.Tensor, inv_mu: torch.Tensor, lmbda: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, M) of the IALM front, the unfused chain of
    swiftwatcher_tpu/ops/rpca.py:353-357, in inv_mu's dtype."""
    dtype = inv_mu.dtype
    Xf, A, Y = X.to(dtype), A.to(dtype), Y.to(dtype)
    im = inv_mu[..., None, None]
    Eraw = Xf - A + im * Y
    E = torch.clamp(Eraw - lmbda * im, min=0.0) + torch.clamp(Eraw + lmbda * im, max=0.0)
    M = Xf - E + im * Y
    return E, M


def ialm_front_reference(
    X: torch.Tensor, A: torch.Tensor, Y: torch.Tensor, inv_mu: torch.Tensor, lmbda: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: (E, M, G)."""
    E, M = front_chain(X, A, Y, inv_mu, lmbda)
    return E, M, M @ M.transpose(-1, -2)


def gram_blocks(T: int):
    """The kernel's Gram schedule for T rows: T padded with zero rows to a
    multiple of 4, and the lower-triangle 4 x 4 blocks (I, J), J <= I, in
    the order the kernel's threads take them (thread t takes block
    t // slices, slice t % slices of the chunk's float4 column groups).
    Returns (padded T, blocks, slices)."""
    tp = -(-T // 4) * 4
    blocks = [(i, j) for i in range(tp // 4) for j in range(i + 1)]
    return tp, blocks, KERNEL_THREADS // len(blocks)


def _check(X, A, Y, inv_mu) -> None:
    if X.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"ialm_front: X must be float32 or uint8, got {X.dtype}")
    if A.dtype not in (torch.float32, torch.bfloat16) or Y.dtype != A.dtype:
        raise ValueError(
            f"ialm_front: A and Y must both be float32 or both bfloat16, got {A.dtype}, {Y.dtype}"
        )
    build.check_operand("ialm_front", X, X.dtype)
    build.check_operand("ialm_front", A, A.dtype, like=X)
    build.check_operand("ialm_front", Y, Y.dtype, like=X)
    B, T, P = X.shape
    if inv_mu.dtype != torch.float32 or inv_mu.shape != (B,) or inv_mu.device != X.device:
        raise ValueError(f"ialm_front: inv_mu must be ({B},) float32 on {X.device}")
    if not inv_mu.is_contiguous():
        raise ValueError("ialm_front: inv_mu must be contiguous")
    if not (1 <= B <= 65535 and 1 <= T <= MAX_T and P >= 1):
        raise ValueError(f"ialm_front: want 1 <= B <= 65535, 1 <= T <= {MAX_T}, P >= 1; "
                         f"got {tuple(X.shape)}")


def ialm_front(
    X: torch.Tensor, A: torch.Tensor, Y: torch.Tensor, inv_mu: torch.Tensor, lmbda: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, P) X, A, Y + (B,) inv_mu -> E, M (B, T, P) and G (B, T, T)."""
    if X.device.type == "cpu":
        return ialm_front_reference(X, A, Y, inv_mu, lmbda)
    out = launch_front("swt_ialm_front", X, A, Y, inv_mu, lmbda)
    ialm_front.launches += 1
    return out


ialm_front.launches = 0


def launch_front(
    entry: str, X: torch.Tensor, A: torch.Tensor, Y: torch.Tensor, inv_mu: torch.Tensor,
    lmbda: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of csrc/ialm_front.cu's `entry` on CUDA operands: the
    kernel (swt_ialm_front), or the same launch without the Gram
    (swt_ialm_front_stream: G is left unwritten), which times K6's parts."""
    _check(X, A, Y, inv_mu)
    B, T, P = X.shape
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    n_blocks = min(-(-P // CHUNK), max(1, -(-sms * _BLOCKS_PER_SM // B)))
    E = torch.empty((B, T, P), dtype=torch.float32, device=X.device)
    M = torch.empty_like(E)
    G = torch.empty((B, T, T), dtype=torch.float32, device=X.device)
    partial = torch.empty((B, n_blocks, T * (T + 1) // 2), dtype=torch.float32,
                          device=X.device)
    build.launch(
        "ialm_front", entry, X.device,
        X.data_ptr(), A.data_ptr(), Y.data_ptr(), inv_mu.data_ptr(),
        E.data_ptr(), M.data_ptr(), partial.data_ptr(), G.data_ptr(),
        B, T, P, n_blocks, int(X.dtype == torch.uint8), int(A.dtype == torch.bfloat16),
        float(lmbda),
    )
    return E, M, G
