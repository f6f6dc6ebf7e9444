"""Peaks of the card and the work the localisation needs.

The least time of some work is the larger of its bytes over the HBM's
bandwidth and its operations over the f32 peak outside the tensor cores
(NVIDIA's data sheet for the H100 SXM, dense, at its full 700 W; the same
arithmetic as the port's chip_smoke.bound, copied).  Work is counted from
the cell's shapes and the measured IALM trips, each input byte read once
and each output byte written once, whatever implements it:

  IALM trip, per window   X read (uint8 when the solver holds it so), A, E
                          and Y read and written in the solver's storage
                          dtype; the Gram M M^T and the projection Q M,
                          2 T^2 P operations each
  stabilisation, a frame  the gray crop read and the aligned crop written
  K1 (post-filter)        the uint8 motion plane in, the filtered plane out
  K2 (CCL)                the uint8 foreground plane in, the uint8 label
                          plane out
  props                   the uint8 label plane read

K1's and K2's operations depend on how much of a frame moves, which the
benchmark does not see, so their bound counts bytes alone: a lower bound
on their least time, so their shares stay honest.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

_SIZES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "uint8": 1}


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """Least seconds for n_bytes through HBM and n_ops f32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def solver_bytes(cfg) -> tuple:
    """(bytes of an X element, bytes of an A/E/Y element) as the resolved
    configuration `cfg` stores them."""
    dtype = getattr(cfg, "rpca_dtype", "float32")
    x = 1 if getattr(cfg, "rpca_store_x_u8", False) else _SIZES[dtype]
    state = 2 if getattr(cfg, "rpca_state_bf16", False) and dtype == "float32" else _SIZES[dtype]
    return x, state


def ialm_trip(T: int, P: int, x_bytes: int, state_bytes: int) -> tuple:
    """(bytes, operations) of one IALM trip of one window."""
    return T * P * (x_bytes + 6 * state_bytes), 2 * (2 * T * T * P)


def frame_plane_bytes(P: int, stabilize: bool) -> dict:
    """Bytes a frame needs in each layer after RPCA."""
    return {"k1": 2 * P, "k2": 2 * P, "props": P, "stabilize": 2 * P if stabilize else 0}


def localize_batch(B: int, T: int, P: int, trips: float, cfg, stabilize: bool) -> tuple:
    """(bytes, operations) of one batch's localisation, `trips` the mean
    IALM trips of a window."""
    tb, to = ialm_trip(T, P, *solver_bytes(cfg))
    planes = sum(frame_plane_bytes(P, stabilize).values())
    return B * trips * tb + B * T * planes, B * trips * to


# SqueezeNet 1.0 (Iandola et al., arXiv:1602.07360, torchvision
# squeezenet1_0): (squeeze, expand 1x1, expand 3x3) of the fire modules
# between the stem's pool and the head, None a max pool (3, stride 2, ceil)
SQUEEZENET_1_0 = ((16, 64, 64), (16, 64, 64), (32, 128, 128), None, (32, 128, 128),
                  (48, 192, 192), (48, 192, 192), (64, 256, 256), None, (64, 256, 256))


def squeezenet_forward(n_crops: int, input_size: int, classes: int = 2) -> tuple:
    """(bytes, operations) of SqueezeNet 1.0's forward over n_crops
    float32 inputs of input_size squared: the input read and the logits
    written once, the weights and biases read once; 2 operations a
    multiply-add of every convolution (the stem's 7x7/2, each fire
    module's three, the head's 1x1 to `classes`).  Pools, ReLUs and the
    average are left out: their operations are not 1% of these."""
    def pool(x):
        return -(-(x - 3) // 2) + 1

    macs = params = 0

    def conv(side, cin, cout, k):
        nonlocal macs, params
        macs += side * side * cout * cin * k * k
        params += cout * cin * k * k + cout

    side = (input_size - 7) // 2 + 1
    conv(side, 3, 96, 7)
    side, cin = pool(side), 96
    for fire in SQUEEZENET_1_0:
        if fire is None:
            side = pool(side)
            continue
        s, e1, e3 = fire
        conv(side, cin, s, 1)
        conv(side, s, e1, 1)
        conv(side, s, e3, 3)
        cin = e1 + e3
    conv(side, cin, classes, 1)
    n_bytes = 4 * (n_crops * (3 * input_size * input_size + classes) + params)
    return n_bytes, 2 * macs * n_crops
