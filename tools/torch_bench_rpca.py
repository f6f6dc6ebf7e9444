"""Microbenchmark of the port's batched IALM solver (the pipeline's hot
stage): milliseconds per trip of its loop.

Counterpart of tools/bench_rpca.py for swiftwatcher_tpu_torch.  Times
`ops/rpca.py:ialm_rpca_batched` on crop-shaped windows of the bench scene
(16 windows of the 216 x 432 crop at the defaults, so P = 93312) for each
variant named, and prints the milliseconds per trip of the solver's loop,
the trip count (the batch's largest iteration count) and the iteration
drift against the first variant.  `production` is the shipped
configuration, taken from `ialm_gates_and_kwargs` as the pipeline takes
it; the others set the warm eigenbasis and the storage dtypes of X, Y and
(A, E) by hand.  Each variant is timed on the host clock around calls
that end in `torch.cuda.synchronize`, with the CUDA-event time of the same
calls beside it (the solver reads its stop flag on the host every trip).
Beside them: the byte floor of one pass over a (B, T, P) f32 array, at the
H100 SXM's 3.35 TB/s.

    python tools/torch_bench_rpca.py [--batch 16] [--reps 5]
        [--variants production warm cold ...] [--device cpu]

Runs on the card unless --device says otherwise (on the CPU the times are
the CPU's, and no CUDA-event time is taken).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import card_line, device_from_arg, pin_numerics  # noqa: E402
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host  # noqa: E402
from swiftwatcher_tpu_torch.ops.rpca import ialm_gates_and_kwargs, ialm_rpca_batched  # noqa: E402

# H100 SXM HBM3 peak (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

# the keywords of the shipped configuration that the variants set
STORAGE_KEYS = ("warm_basis", "fused_front", "x_store_dtype", "store_y_dtype",
                "store_ae_dtype")


def make_batch(B: int, device=torch.device("cuda")) -> torch.Tensor:
    """Crop-shaped (B, 21, P) f32 batch from the standard synthetic scene,
    with per-window variety (shifted copies) so convergence is realistic."""
    cfg = DEFAULT_CONFIG
    video = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    (x1, y1), (x2, y2) = crop_region_from_corners(video.corners, cfg)
    T = cfg.window_size
    wins = []
    for b in range(B):
        s = (b * 7) % (63 - T)
        wins.append(bgr_to_gray_host(video.frames[s:s + T, y1:y2, x1:x2, :]))
    gray = np.stack(wins)  # (B, T, H, W) u8
    X = gray.reshape(B, T, -1).astype(np.float32)
    return torch.from_numpy(X).to(device)


def variants(device) -> dict:
    """Name -> ialm_rpca_batched keywords.  `production` is the shipped
    configuration from the gate helper the pipeline uses (never a hand
    copy of its knobs: 'warm' alone is not the production default)."""
    prod_kwargs = ialm_gates_and_kwargs(DEFAULT_CONFIG, torch.float32, device)
    return {
        "production": {k: v for k, v in prod_kwargs.items() if k in STORAGE_KEYS},
        "warm": dict(warm_basis=True),
        "cold": dict(warm_basis=False),
        # storage-dtype experiments
        "warm-x8": dict(warm_basis=True, x_store_dtype="uint8"),
        "warm-xbf16": dict(warm_basis=True, x_store_dtype="bfloat16"),
        "warm-ybf16": dict(warm_basis=True, store_y_dtype="bfloat16"),
        "warm-x8-ybf16": dict(warm_basis=True, x_store_dtype="uint8",
                              store_y_dtype="bfloat16"),
        "warm-bf16all": dict(warm_basis=True, x_store_dtype="uint8",
                             store_y_dtype="bfloat16", store_ae_dtype="bfloat16"),
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_variant(X: torch.Tensor, reps: int, **kw) -> dict:
    """One untimed call, then `reps` timed ones: the mean host ms a call
    (each ends in a synchronize), the mean CUDA-event ms (None on the CPU),
    the trips and the (B,) iterations of the first call."""
    cfg = DEFAULT_CONFIG
    kw.setdefault("lmbda", cfg.rpca_lambda)
    kw.setdefault("tol", cfg.rpca_tol)
    kw.setdefault("max_iter", cfg.rpca_max_iter)
    device = X.device
    _, _, iters = ialm_rpca_batched(X, **kw)
    iters = iters.cpu().numpy()
    cuda = device.type == "cuda"
    host, events = [], []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        _sync(device)
        t0 = time.perf_counter()
        _, E, _ = ialm_rpca_batched(X, **kw)
        if cuda:
            end.record()
        _sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            events.append(start.elapsed_time(end))
        del E
    return dict(ms=float(np.mean(host)), event_ms=float(np.mean(events)) if cuda else None,
                samples_ms=[round(v, 3) for v in host], trips=int(iters.max()), iters=iters)


def pass_floor(X: torch.Tensor) -> tuple:
    """(MB, ms) of one f32 pass over a (B, T, P) array at HBM_BYTES_PER_S."""
    n_bytes = X.numel() * 4
    return n_bytes / 1e6, n_bytes / HBM_BYTES_PER_S * 1e3


def run_variants(X: torch.Tensor, names, reps: int) -> list:
    """time_variant for each name, with ms per trip and the iteration drift
    against the first variant."""
    table = variants(X.device)
    rows = []
    for name in names:
        r = time_variant(X, reps, **table[name])
        base_iters = rows[0]["iters"] if rows else r["iters"]
        r.update(name=name, ms_per_trip=r["ms"] / r["trips"],
                 drift=int(np.abs(r["iters"].astype(int) - base_iters.astype(int)).max()))
        rows.append(r)
    return rows


def format_row(r: dict, floor_ms: float) -> str:
    line = (f"{r['name']:>16}: {r['ms']:8.1f} ms total  {r['ms_per_trip']:6.2f} ms/trip "
            f"({r['trips']} trips, iter drift vs first variant: {r['drift']})")
    if r["event_ms"] is None:
        return line
    return (line + f"; CUDA events {r['event_ms']:8.1f} ms ({r['event_ms'] / r['trips']:6.2f} "
            f"ms/trip); {r['ms_per_trip'] / floor_ms:.0f}x the pass floor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", nargs="*", default=["production", "warm", "cold"],
                    help="names: production (the shipped config, derived from "
                    "ialm_gates_and_kwargs), cold, warm, warm-bf16all, ... (see variants())")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    unknown = [n for n in args.variants if n not in variants(device)]
    if unknown:
        ap.error(f"unknown variants {unknown}; have {list(variants(device))}")
    if device.type == "cuda":
        pin_numerics()
        print(f"# {card_line(device)}")

    X = make_batch(args.batch, device)
    B, T, P = X.shape
    pass_mb, floor_ms = pass_floor(X)
    print(f"# B={B} T={T} P={P}  one f32 (B,T,P) pass = {pass_mb:.0f} MB = {floor_ms:.4f} ms "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s (on {device})")
    for r in run_variants(X, args.variants, args.reps):
        print(format_row(r, floor_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
