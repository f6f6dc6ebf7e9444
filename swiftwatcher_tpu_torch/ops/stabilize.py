"""Opt-in electronic image stabilisation for jittery footage.

Counterpart of swiftwatcher_tpu/ops/stabilize.py (plain XLA there, no
Pallas kernel), as torch ops on the caller's device.  The reference's RPCA
background assumes a static scene, so camera shake turns every edge into
"motion".  stabilize_window aligns each frame of a window to a reference
pose by an exhaustive integer-shift search:

  1. the reference R: in the pipeline, the gray crop of the frame the ROI
     mask is built from (pipeline/runner.py), so the mask and every
     window's centroids share one pose; without one, each window's
     rounded temporal mean;
  2. for every candidate shift (dy, dx) in [-J, J]^2, the SAD of the frame's
     slice of an edge-padded copy against R, in integers;
  3. each frame becomes its argmin candidate (ties go to the lower
     candidate index), by a masked select over the same slices.

All arithmetic is in integers, so the scores and the choice are exact in
any summation order: the card and the CPU give the same bytes, and so
does the JAX package.  Off by default (config.stabilize_max_shift = 0).

Route (`kernel_route`, from the input alone).  J = 0 returns the input.  A
contiguous CUDA u8 (..., T, H, W) batch with 1 <= J <= MAX_J, a u8 (H, W)
reference or none, and a frame the kernel takes (H * W * 255 < 2^31, a
staged band within shared memory: `search_layout`) runs K9,
csrc/stabilize.cu: K9a sums every candidate's SAD of a frame into an int32
(N, (2J+1)^2), K9b takes each frame's argmin and gathers its slice.  With
no reference, K9a reads each window's rounded mean, the plain chain's
integer expression (`window_mean`), as a u8 reference a window.
Everything else (the CPU, another dtype, a strided batch, J > MAX_J, an
int32 reference) runs the plain chain, `stabilize_window_reference`.  Both
give the same bytes and shifts (tests/test_torch_stabilize_kernel.py
emulates K9's schedule; chip_smoke.py phase 21 holds K9 to the plain chain
on the card).  Each K9 call counts in the bound run's counter
`stabilize.launches`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import build
from ..utils.metrics import count

MAX_J = 4
# K9a's staging (csrc/stabilize.cu): a band of at most SEARCH_ROWS output
# rows a block, each staged row at byte STAGE_OFF of a row of `stride`
# bytes; the padded rows and the reference rows (dynamic shared memory)
# with the block's static `total` of (2J+1)^2 int32, at most STATIC_BYTES,
# within SMEM_BYTES, the most a block has without an opt-in.
SEARCH_ROWS = 32
STAGE_OFF = 16
SMEM_BYTES = 48 * 1024
STATIC_BYTES = 4 * (2 * MAX_J + 1) ** 2
GATHER_ROWS = 8  # output rows a K9b block copies


def _edge_pad(gray: torch.Tensor, J: int) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2J, W + 2J), the edge rows and columns
    repeated, by clamped indices (replicate padding is not defined for u8
    on every backend)."""
    H, W = gray.shape[-2:]
    rows = torch.arange(-J, H + J, device=gray.device).clamp_(0, H - 1)
    cols = torch.arange(-J, W + J, device=gray.device).clamp_(0, W - 1)
    return gray.index_select(-2, rows).index_select(-1, cols)


def window_mean(gray: torch.Tensor) -> torch.Tensor:
    """Each window's round-half-up integer mean over T, (..., 1, H, W)
    int32, from 0 to 255."""
    T = gray.shape[-3]
    return torch.div(gray.to(torch.int32).sum(-3, keepdim=True) * 2 + T, 2 * T,
                     rounding_mode="floor")


def _no_shift(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return gray, torch.zeros((*gray.shape[:-2], 2), dtype=torch.int32, device=gray.device)


def stabilize_window_reference(
    gray: torch.Tensor, max_shift: int, ref: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """stabilize_window as the plain chain: (2J+1)^2 int32 candidate planes
    and as many masked selects."""
    if max_shift <= 0:
        return _no_shift(gray)
    J = int(max_shift)
    n = 2 * J + 1
    H, W = gray.shape[-2:]
    if ref is None:
        ref = window_mean(gray)                             # (..., 1, H, W)
    else:
        ref = ref.to(device=gray.device, dtype=torch.int32)
    padded = _edge_pad(gray, J)

    # one candidate plane at a time (all of them at once would take
    # (2J+1)^2 int32 copies of the batch); keep only the SAD sums
    sads = torch.stack([
        (padded[..., a : a + H, b : b + W].to(torch.int32) - ref).abs_().sum((-2, -1))
        for a in range(n) for b in range(n)
    ])                                                      # (C, ..., T)
    # argmin with ties to the lowest candidate index, independent of how a
    # backend's argmin breaks ties
    index = torch.arange(n * n, device=gray.device).reshape(-1, *[1] * (sads.dim() - 1))
    best = torch.where(sads == sads.min(0).values, index, n * n).min(0).values  # (..., T)

    out = torch.zeros_like(gray)
    for c in range(n * n):
        a, b = divmod(c, n)
        out = torch.where((best == c)[..., None, None], padded[..., a : a + H, b : b + W], out)
    shifts = torch.stack([best // n - J, best % n - J], dim=-1).to(torch.int32)
    return out, shifts


def search_layout(H: int, W: int, J: int) -> Tuple[int, int]:
    """(rows, stride) of K9a's staging for (H, W) frames: output rows a
    band and bytes a staged row (the row at STAGE_OFF, room for J <= MAX_J
    halo columns each side and the 3 words a thread reads past its own);
    rows < 1 where a band of one row does not fit in SMEM_BYTES beside the
    static STATIC_BYTES."""
    stride = -(-(STAGE_OFF + W + 12) // 16) * 16
    rows = min(SEARCH_ROWS, H, ((SMEM_BYTES - STATIC_BYTES) // stride - 2 * J) // 2)
    return rows, stride


def kernel_route(device: torch.device, dtype: torch.dtype, shape, contiguous: bool,
                 max_shift: int, ref_dtype: Optional[torch.dtype] = None,
                 ref_shape=None) -> bool:
    """Whether stabilize_window of a `shape` batch of `dtype` on `device`
    (`contiguous` or not) with a reference of ref_dtype and ref_shape (None:
    no reference) runs K9: a contiguous CUDA u8 (..., T, H, W) batch of at
    least one frame, 1 <= J <= MAX_J, a u8 (H, W) reference or none,
    H * W * 255 < 2^31 (a frame's SAD in int32), N * H < 2^31 (the grids)
    and a band that fits K9a's shared memory."""
    shape = tuple(shape)
    if len(shape) < 3 or not 1 <= max_shift <= MAX_J:
        return False
    H, W = shape[-2:]
    N = math.prod(shape[:-2])
    return (
        torch.device(device).type == "cuda"
        and dtype == torch.uint8
        and contiguous
        and N >= 1 and H >= 1 and W >= 1
        and H * W * 255 < 2 ** 31
        and search_layout(H, W, max_shift)[0] >= 1
        and N * H < 2 ** 31
        and (ref_dtype is None or (ref_dtype == torch.uint8 and tuple(ref_shape) == (H, W)))
    )


def stabilize_window(
    gray: torch.Tensor, max_shift: int, ref: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align (..., T, H, W) uint8 frames to a reference pose.

    ref: an (H, W) uint8 or int32 reference image; None takes each
    window's rounded temporal mean.  Returns (aligned u8, shifts int32),
    where shifts[..., t] = (dy, dx) is the chosen displacement:
    aligned[t, y, x] = edgepad(gray)[t, y + dy + J, x + dx + J].  J = 0
    returns the input unchanged.  K9 where kernel_route picks it, else the
    plain chain; the same bytes either way."""
    if max_shift <= 0:
        return _no_shift(gray)
    J = int(max_shift)
    if not kernel_route(gray.device, gray.dtype, gray.shape, gray.is_contiguous(), J,
                        None if ref is None else ref.dtype,
                        None if ref is None else ref.shape):
        return stabilize_window_reference(gray, J, ref)
    H, W = gray.shape[-2:]
    frames = gray.reshape(-1, H, W)
    if ref is None:
        refs = window_mean(gray).to(torch.uint8).reshape(-1, H, W)
    else:
        refs = ref.to(gray.device).contiguous().reshape(1, H, W)
    sads = launch_search(frames, refs, J)
    out, shifts = launch_gather(frames, sads, J)
    count("stabilize.launches")
    return out.reshape(gray.shape), shifts.reshape(*gray.shape[:-2], 2)


def launch_search(gray: torch.Tensor, refs: torch.Tensor, J: int) -> torch.Tensor:
    """K9a on CUDA operands: gray (N, H, W) u8, refs (R, H, W) u8 with R 1
    (one pose) or N / T windows of T frames each; returns sads, (N,
    (2J+1)^2) int32."""
    build.check_operand("stabilize_search", gray, torch.uint8)
    build.check_operand("stabilize_search", refs, torch.uint8)
    N, H, W = gray.shape
    R = refs.shape[0]
    if refs.shape[1:] != (H, W) or refs.device != gray.device or R < 1 or N % R:
        raise ValueError(f"stabilize_search: references {tuple(refs.shape)} do not divide "
                         f"frames {tuple(gray.shape)} into windows")
    rows, stride = search_layout(H, W, J)
    if not 1 <= J <= MAX_J or rows < 1 or H * W * 255 >= 2 ** 31:
        raise ValueError(f"stabilize_search: J {J} or frame {H}x{W} outside the kernel's limits")
    sads = torch.zeros((N, (2 * J + 1) ** 2), dtype=torch.int32, device=gray.device)
    build.launch(
        "stabilize", "swt_stabilize_search", gray.device,
        gray.data_ptr(), refs.data_ptr(), sads.data_ptr(), N, N // R, H, W, J,
        0 if R == 1 else H * W, rows, stride,
    )
    return sads


def launch_gather(gray: torch.Tensor, sads: torch.Tensor, J: int):
    """K9b on CUDA operands: each frame of gray (N, H, W) u8 moved by the
    argmin of its row of sads (N, (2J+1)^2) int32; returns (aligned (N, H,
    W) u8, shifts (N, 2) int32)."""
    build.check_operand("stabilize_gather", gray, torch.uint8)
    N, H, W = gray.shape
    if not 1 <= J <= MAX_J:
        raise ValueError(f"stabilize_gather: J {J} outside 1..{MAX_J}")
    if (sads.dtype != torch.int32 or tuple(sads.shape) != (N, (2 * J + 1) ** 2)
            or sads.device != gray.device or not sads.is_contiguous()):
        raise ValueError(f"stabilize_gather: sads must be a contiguous ({N}, "
                         f"{(2 * J + 1) ** 2}) int32 tensor on {gray.device}")
    out = torch.empty_like(gray)
    shifts = torch.empty((N, 2), dtype=torch.int32, device=gray.device)
    build.launch(
        "stabilize", "swt_stabilize_gather", gray.device,
        gray.data_ptr(), sads.data_ptr(), out.data_ptr(), shifts.data_ptr(), N, H, W, J,
    )
    return out, shifts
