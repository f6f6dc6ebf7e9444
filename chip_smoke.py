#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from swiftwatcher_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, and drives the counting main
path (`run_video`) end to end:

  1. the card's name and power limit (nvidia-smi);
  2. kernel build time;
  3. K1 (fused motion filter) vs the plain chain at (336, 216, 432), on RPCA
     motion of the 1080p scene plus tile-boundary cases: bit-equal;
  4. K2 (fused CCL) vs its plain version: swept labels, compact labels and
     flags bit-equal, on that motion plus a snake and a dense speckle;
     then the slow-path kernels on the frames K2 flags, each vs its plain
     version at the planes the slow path hands it: K5 (sweep chunk) on
     K2's swept labels, K3 (whole-frame convergence) on the labels after
     K5's sweep budget, K4 (rank compaction) on the converged labels, all
     bit-equal; label_components on the card equals it on the CPU;
  5. run_video on the small synthetic scene on the card and on the CPU:
     equal events, 2 predicted and 1 rejected;
  6. run_video over 1008 frames of the 1080p scene (216 x 432 crop):
     events > 0, and each kernel launched on that run.

The 1080p scene is the bench scene (make_video at 1080 x 1920) with a
large bird passing close to the camera in 4 frames of its 63: a 64 x 64
blob, deeper than the fast path's sweeps, so those frames take the CCL
slow path and its kernels run on the main path.

Prints kernel and end-to-end times on the way, then a {"kernels": [...]}
line, the card line again, and last {"ok": true, "device": {...}}.  Exits
nonzero, printing no result, on any failure or when no CUDA device exists.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

TOL = 0  # every comparison below is bit-equal


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device milliseconds per call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def alternate_ms(torch, plain, kernel, reps: int = 10):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps)
    k2 = time_ms(torch, kernel, reps)
    p2 = time_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def boundary_motion(np, H: int, W: int) -> "np.ndarray":
    """Frames that probe K1's tile edges and its early-out: empty, all at
    the threshold, all above it, and lone bright pixels on sub-threshold
    noise at and around every 32 x 64 tile seam and the frame border."""
    rng = np.random.default_rng(7)
    frames = [
        np.zeros((H, W), np.uint8),
        np.full((H, W), 15, np.uint8),
        np.full((H, W), 16, np.uint8),
    ]
    rows = [r for r in (0, 1, 2, 30, 31, 32, 33, 34, 63, 64, 65, H - 3, H - 2, H - 1)
            if r < H]
    cols = [c for c in (0, 1, 2, 61, 62, 63, 64, 65, 66, 127, 128, W - 3, W - 2, W - 1)
            if c < W]
    for i in range(0, len(rows), 2):
        m = (rng.random((H, W)) * 14).astype(np.uint8)
        for r in rows[i : i + 2]:
            for c in cols:
                m[r, c] = 120
        frames.append(m)
    return np.stack(frames)


# K1 shapes and settings beyond the main path's: ragged tiles, frames
# smaller than a tile, other bilateral radii and thresholds, and weights
# of exactly 1 and 0.5 that make exact .5 rounding ties (half to even).
K1_EXTRA = (
    ((3, 60, 90), {"bilateral_d": 3, "bilateral_sigma_color": 1e7,
                   "bilateral_sigma_space": math.sqrt(0.5 / math.log(2)),
                   "motion_threshold": 0}),
    ((4, 47, 121), {}),
    ((2, 5, 70), {}),
    ((3, 100, 7), {}),
    ((3, 60, 90), {"bilateral_d": 5}),
    ((3, 60, 90), {"bilateral_d": 9, "motion_threshold": 30}),
)
# K2 shapes beyond the main path's, with a foreground density each.
K2_EXTRA = (((4, 47, 121), 0.3), ((2, 1, 500), 0.5), ((2, 300, 1), 0.5),
            ((3, 64, 64), 0.7))


def blob_motion(np, rng, shape) -> "np.ndarray":
    """Sub-threshold noise with a few bright blobs per frame."""
    N, H, W = shape
    m = rng.integers(0, 12, size=shape).astype(np.uint8)
    for n in range(N):
        for _ in range(4):
            y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
            m[n, y : y + 4, x : x + 4] = int(rng.integers(40, 220))
    return m


def snake_frames(np, H: int, W: int) -> "np.ndarray":
    """A serpentine component (flood distance >> 12) and a dense speckle
    whose giant component forces the slow path."""
    snake = np.zeros((H, W), bool)
    for r in range(0, H, 4):
        snake[r, 1 : W - 1] = True
        c = W - 2 if (r // 4) % 2 == 0 else 1
        snake[r : min(r + 4, H), c] = True
    speckle = np.random.default_rng(3).random((H, W)) > 0.62
    return np.stack([snake, speckle])


def close_pass(np, frames: "np.ndarray") -> "np.ndarray":
    """The 1080p bench clip with a dark 64 x 64 block crossing the sky of
    the chimney crop, 110 px a frame, in frames 57-60 (after every actor of
    the clip has gone)."""
    out = frames.copy()
    for k, t in enumerate(range(57, 61)):
        x = 780 + 110 * k
        block = out[t, 440:504, x : x + 64].astype(np.int16) - 120
        out[t, 440:504, x : x + 64] = np.clip(block, 0, 255)
    return out


def f32_err(a, b) -> float:
    """max |a - b| over two f32 planes."""
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def run() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device (torch.cuda.is_available() is False)")
    from swiftwatcher_tpu_torch import build
    from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
    from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource
    from swiftwatcher_tpu_torch.io.synthetic import make_video
    from swiftwatcher_tpu_torch.ops.ccl import label_components
    from swiftwatcher_tpu_torch.ops.ccl_local import converge_frames, converge_frames_reference
    from swiftwatcher_tpu_torch.ops.ccl_sweep import sweep_chunk, sweep_chunk_reference
    from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
    from swiftwatcher_tpu_torch.ops.fused_motion import (
        fused_motion_filter,
        fused_motion_filter_reference,
    )
    from swiftwatcher_tpu_torch.ops.rank_compact import (
        RANK_SWEEPS,
        label_rank_fused,
        label_rank_fused_reference,
        rank_seed_sweep,
        rank_seed_sweep_reference,
    )
    from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    cfg = DEFAULT_CONFIG
    dev = require_cuda()
    pin_numerics()

    # 1. the card
    card = gpu_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    secs = build.build_all()
    print(f"phase 2 build: {secs:.2f} s for {', '.join(build.KERNEL_SOURCES)}", flush=True)

    # 3. K1 at the main path's shape: RPCA motion of one batch of the scene
    t0 = time.perf_counter()
    bench = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    bench.frames = close_pass(np, bench.frames)
    print(f"1080p scene built in {time.perf_counter() - t0:.1f} s", flush=True)
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    B, T = cfg.batch_windows, cfg.window_size
    idx = np.arange(B * T) % len(bench.frames)
    gray = bgr_to_gray_host(bench.frames[idx, y1:y2, x1:x2])
    H, W = gray.shape[1:]
    gray_dev = torch.from_numpy(gray.reshape(B, T, H, W)).to(dev)
    motion, iters = rpca_motion_window_batched(gray_dev, cfg)
    motion = motion.reshape(B * T, H, W).contiguous()
    print(f"phase 3 input: motion {tuple(motion.shape)}, RPCA iters "
          f"{iters.min().item()}..{iters.max().item()}, "
          f"{int((motion > cfg.motion_threshold).sum())} px above threshold", flush=True)
    k1_in = torch.cat([motion, torch.from_numpy(boundary_motion(np, H, W)).to(dev)])
    got = fused_motion_filter(k1_in, cfg)
    want = fused_motion_filter_reference(k1_in, cfg)
    torch.cuda.synchronize()
    k1_err = int((got.int() - want.int()).abs().max())
    k1_bad = int((got != want).sum())
    print(f"phase 3 K1 vs plain on {tuple(k1_in.shape)}: max |diff| {k1_err}, "
          f"{k1_bad} px differ", flush=True)
    check(k1_err <= TOL, "K1 disagrees with the plain chain")
    check(int((got[: B * T] > 0).sum()) > 0, "K1 output holds no motion")
    rng = np.random.default_rng(11)
    for shape, overrides in K1_EXTRA:
        c = dataclasses.replace(cfg, **overrides)
        m = torch.from_numpy(blob_motion(np, rng, shape)).to(dev)
        err = int((fused_motion_filter(m, c).int()
                   - fused_motion_filter_reference(m, c).int()).abs().max())
        check(err <= TOL, f"K1 disagrees with the plain chain at {shape} {overrides}")
    print(f"phase 3 K1 vs plain on {len(K1_EXTRA)} other shapes/settings: bit-equal",
          flush=True)
    k1_ms, k1_plain_ms = alternate_ms(
        torch,
        lambda: fused_motion_filter_reference(motion, cfg),
        lambda: fused_motion_filter(motion, cfg),
    )
    print(f"phase 3 K1 time at {tuple(motion.shape)}: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms [{card}]", flush=True)

    # 4. K2 on the filtered motion plus frames that force the slow path
    fg_main = (fused_motion_filter(motion, cfg) > 0).contiguous()
    fg = torch.cat([fg_main, torch.from_numpy(snake_frames(np, H, W)).to(dev)]).contiguous()
    lk, ck, fk = label_rank_fused(fg, RANK_SWEEPS)
    lp, cp, fp = label_rank_fused_reference(fg, RANK_SWEEPS)
    torch.cuda.synchronize()
    k2_err = int((ck.long() - cp.long()).abs().max())
    print(f"phase 4 K2 vs plain on {tuple(fg.shape)}: labels max |diff| {k2_err}, "
          f"swept equal {torch.equal(lk, lp)}, flags equal {torch.equal(fk, fp)}, "
          f"flagged frames {fk.nonzero().flatten().tolist()}", flush=True)
    check(k2_err <= TOL and torch.equal(lk, lp) and torch.equal(fk, fp),
          "K2 disagrees with its plain version")
    check(bool(fk[-2]) and bool(fk[-1]), "the snake frames did not take the slow path")
    check(bool(fk[: B * T].any()), "no frame of the 1080p scene takes the slow path")
    for shape, density in K2_EXTRA:
        f = torch.from_numpy(rng.random(shape) < density).to(dev)
        for a, b in zip(label_rank_fused(f, RANK_SWEEPS),
                        label_rank_fused_reference(f, RANK_SWEEPS)):
            check(torch.equal(a, b), f"K2 disagrees with its plain version at {shape}")
    print(f"phase 4 K2 vs plain on {len(K2_EXTRA)} other shapes: bit-equal", flush=True)
    k2_ms, k2_plain_ms = alternate_ms(
        torch,
        lambda: label_rank_fused_reference(fg_main, RANK_SWEEPS),
        lambda: label_rank_fused(fg_main, RANK_SWEEPS),
    )
    print(f"phase 4 K2 time at {tuple(fg_main.shape)}: kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms [{card}]", flush=True)

    # the slow path's kernels on the flagged frames, at the planes it gives them
    slow = fk.nonzero().flatten()
    fg_s, P = fg[slow].contiguous(), float(H * W)
    k5_in = lk[slow].contiguous()
    k3_in = sweep_chunk_reference(k5_in, fg_s, 24, P)
    k4_in = converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P)
    check(torch.equal(k4_in, sweep_chunk_reference(k4_in, fg_s, 1, P)),
          "the plain K3 did not reach the fixpoint")
    slow_cases = {
        "sweep_chunk": (lambda: sweep_chunk(k5_in, fg_s, 4, P),
                        lambda: sweep_chunk_reference(k5_in, fg_s, 4, P)),
        "converge_frames": (lambda: converge_frames(k3_in, fg_s, cfg.ccl_max_iters, P),
                            lambda: converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P)),
        "rank_seed_sweep": (lambda: rank_seed_sweep(k4_in, RANK_SWEEPS),
                            lambda: rank_seed_sweep_reference(k4_in, RANK_SWEEPS)),
    }
    slow_err, slow_ms = {}, {}
    for name, (kernel, plain) in slow_cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        slow_err[name] = f32_err(got, want)
        check(torch.equal(got, want), f"{name} disagrees with its plain version")
        slow_ms[name] = alternate_ms(torch, plain, kernel, reps=3)
        print(f"phase 4 {name} vs plain on {tuple(fg_s.shape)}: max |diff| "
              f"{slow_err[name]}, kernel {slow_ms[name][0]:.4f} ms, "
              f"plain {slow_ms[name][1]:.4f} ms [{card}]", flush=True)
    # K3 also finishes rank floods: the rank map after K4 and K5's budget
    r_in = sweep_chunk_reference(rank_seed_sweep_reference(k4_in, RANK_SWEEPS), fg_s, 24, P)
    got = converge_frames(r_in, fg_s, cfg.ccl_max_iters, P)
    want = converge_frames_reference(r_in, fg_s, cfg.ccl_max_iters, P)
    slow_err["converge_frames"] = max(slow_err["converge_frames"], f32_err(got, want))
    check(torch.equal(got, want), "converge_frames disagrees with its plain version on ranks")
    before = label_components.slow_path_frames
    lab_gpu, cnt_gpu = label_components(fg, cfg.ccl_max_iters)
    check(label_components.slow_path_frames > before, "slow path not taken")
    lab_cpu, cnt_cpu = label_components(fg.cpu(), cfg.ccl_max_iters)
    check(torch.equal(lab_gpu.cpu(), lab_cpu) and torch.equal(cnt_gpu.cpu(), cnt_cpu),
          "label_components on the card differs from the CPU")
    print(f"phase 4 label_components card == CPU, counts of the slow frames "
          f"{cnt_gpu[slow].tolist()}", flush=True)

    # 5. the small scene on the card and on the CPU
    small = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
    res = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        res[d.type] = run_video(ArraySource(small.frames, fps=small.fps),
                                small.corners, cfg, d)
        print(f"phase 5 run_video on {d.type}: {time.perf_counter() - t0:.2f} s, "
              f"{res[d.type].total_predicted} predicted / "
              f"{res[d.type].total_rejected} rejected", flush=True)

    def ev(r):
        return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]

    check(ev(res["cuda"]) == ev(res["cpu"]), "events differ between card and CPU")
    check((res["cuda"].total_predicted, res["cuda"].total_rejected) == (2, 1),
          "small scene: want 2 predicted / 1 rejected")

    # 6. the main path at 1080p, with the launch counters read around it
    n_frames = 3 * B * T
    wrappers = {"fused_motion_filter": fused_motion_filter,
                "label_rank_fused": label_rank_fused,
                "sweep_chunk": sweep_chunk,
                "converge_frames": converge_frames,
                "rank_seed_sweep": rank_seed_sweep}
    for w in wrappers.values():
        w.launches = 0
    slow_before = label_components.slow_path_frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r6 = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                   bench.corners, cfg, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    slow_frames = label_components.slow_path_frames - slow_before
    print(f"phase 6 run_video 1080p: {r6.frames_processed} frames in {secs:.2f} s = "
          f"{r6.frames_processed / secs:.1f} frames/s [{card}], "
          f"{len(r6.events)} events ({r6.total_predicted} predicted / "
          f"{r6.total_rejected} rejected), IALM iters "
          f"{min(r6.ialm_iters)}..{max(r6.ialm_iters)}, slow-path frames "
          f"{slow_frames}, launches {launches}", flush=True)
    check(r6.frames_processed == n_frames, "1080p run processed the wrong frame count")
    check(len(r6.events) > 0, "1080p run found no events")
    check(all(n > 0 for n in launches.values()), "a kernel was not launched on the main path")

    kernels = [
        {"name": "fused_motion_filter", "route": "cuda",
         "source": "swiftwatcher_tpu_torch/csrc/fused_motion.cu",
         "replaces": "swiftwatcher_tpu/ops/pallas/fused_motion.py:153",
         "launches": launches["fused_motion_filter"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "label_rank_fused", "route": "cuda",
         "source": "swiftwatcher_tpu_torch/csrc/rank_compact.cu",
         "replaces": "swiftwatcher_tpu/ops/pallas/rank_compact.py:238",
         "launches": launches["label_rank_fused"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    for name, source, replaces in (
        ("sweep_chunk", "ccl_sweep.cu", "ccl_sweep.py:87"),
        ("converge_frames", "ccl_local.cu", "ccl_local.py:134"),
        ("rank_seed_sweep", "rank_compact.cu", "rank_compact.py:282"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"swiftwatcher_tpu_torch/csrc/{source}",
            "replaces": f"swiftwatcher_tpu/ops/pallas/{replaces}",
            "launches": launches[name], "max_abs_err": slow_err[name],
            "ms": slow_ms[name][0], "plain_ms": slow_ms[name][1]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main() -> int:
    try:
        run()
    except (SmokeFailure, ImportError, RuntimeError, ValueError, OSError,
            subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
