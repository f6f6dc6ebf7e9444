#!/usr/bin/env python3
"""Time the CCL kernels (K2, K3, K4, K5) of trees of the port on the same
inputs, on one GPU.

    python3 tools/time_ccl_slow.py [--trees DIR ...] [--reps 20]

Each DIR is the root of a checkout of this repository (default: this one),
for example an earlier commit unpacked with `git archive` into a
git-ignored directory.  Its `swiftwatcher_tpu_torch` is imported under a
name of its own and builds its kernels into its own `build/kernels/`.

The inputs are chip_smoke.py's close-pass frames: one batch (16 x 21
frames) of the 1080p bench scene with a dark 64 x 64 block crossing the
crop, through this tree's RPCA and K1: K2 on the batch's foreground and
on as many frames of dense speckle (chip_smoke.DENSE_DENSITY); K3-K5 on
the frames K2 flags, with the planes the slow path hands each: K5 (4
sweeps) K2's swept labels, K3 the labels after K5's 24-sweep budget, K4
the converged labels.  Every tree's outputs are checked bit-equal to this
tree's plain versions.

Each kernel of each tree is timed in two ways, in turns over the trees
(A, B, B, A for two): queued behind a spin (chip_smoke.time_ms, device
time) and back to back without one (the timing of earlier revisions of
chip_smoke.py, which includes the host's dispatch of each call when that
takes longer than the kernel).  Prints the card's name and power limit, a
line per kernel, tree and way, and last one JSON object of all the times.
Imports the port only (no JAX).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda  # noqa: E402
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.ops.ccl_local import converge_frames_reference  # noqa: E402
from swiftwatcher_tpu_torch.ops.ccl_sweep import sweep_chunk_reference  # noqa: E402
from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host  # noqa: E402
from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter  # noqa: E402
from swiftwatcher_tpu_torch.ops.rank_compact import (  # noqa: E402
    RANK_SWEEPS,
    label_rank_fused,
    label_rank_fused_reference,
    rank_seed_sweep_reference,
)
from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched  # noqa: E402


def back_to_back_ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds per call between CUDA events recorded around
    back-to-back calls, after a warm-up, with no spin before them."""
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


def load_port(root: Path, alias: str):
    """The `swiftwatcher_tpu_torch` package of the checkout at `root`,
    imported as `alias` (this checkout's under its own name)."""
    if root.resolve() == ROOT:
        return importlib.import_module("swiftwatcher_tpu_torch")
    pkg = root / "swiftwatcher_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def outputs(out):
    """A wrapper's outputs as a tuple (earlier revisions of K4 and K5
    return the plane alone, later ones a flag beside it)."""
    return out if isinstance(out, tuple) else (out,)


def ccl_inputs(dev, cfg):
    """(the batch's foreground, dense speckle of its shape, K5's, K3's and
    K4's input planes and foreground on the frames K2 flags, sentinel) for
    one batch of the close-pass scene."""
    bench = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    frames = chip_smoke.close_pass(np, bench.frames)
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    B, T = cfg.batch_windows, cfg.window_size
    gray = bgr_to_gray_host(frames[np.arange(B * T) % len(frames), y1:y2, x1:x2])
    H, W = gray.shape[1:]
    motion, _ = rpca_motion_window_batched(torch.from_numpy(gray.reshape(B, T, H, W)).to(dev), cfg)
    fg = (fused_motion_filter(motion.reshape(B * T, H, W).contiguous(), cfg) > 0).contiguous()
    lbl, _, flag = label_rank_fused(fg, RANK_SWEEPS)
    slow = flag.nonzero().flatten()
    P = float(H * W)
    fg_s, k5_in = fg[slow].contiguous(), lbl[slow].contiguous()
    k3_in = sweep_chunk_reference(k5_in, fg_s, 24, P)[0]
    k4_in = converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P)
    dense = torch.from_numpy(np.random.default_rng(5).random(tuple(fg.shape))
                             < chip_smoke.DENSE_DENSITY).to(dev)
    return fg, dense, k5_in, k3_in, k4_in, fg_s, P


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, default=[ROOT])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ccl_slow: no CUDA device", file=sys.stderr)
        return 1
    cfg = DEFAULT_CONFIG
    dev = require_cuda()
    pin_numerics()
    card = chip_smoke.gpu_line()
    print(card, flush=True)
    fg, dense, k5_in, k3_in, k4_in, fg_s, P = ccl_inputs(dev, cfg)
    print(f"inputs: K2 on {tuple(fg.shape)}, K3-K5 on the {fg_s.shape[0]} frames K2 flags "
          f"in one batch of the close-pass scene", flush=True)
    plain = {
        "K2": label_rank_fused_reference(fg, RANK_SWEEPS),
        "K2 dense": label_rank_fused_reference(dense, RANK_SWEEPS),
        "K5": sweep_chunk_reference(k5_in, fg_s, 4, P),
        "K3": (converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P),),
        "K4": rank_seed_sweep_reference(k4_in, RANK_SWEEPS),
    }
    calls = {}
    for i, root in enumerate(args.trees):
        port = load_port(root, f"swt_tree{i}")
        sweep = importlib.import_module(f"{port.__name__}.ops.ccl_sweep").sweep_chunk
        local = importlib.import_module(f"{port.__name__}.ops.ccl_local").converge_frames
        compact = importlib.import_module(f"{port.__name__}.ops.rank_compact")
        rank, fused = compact.rank_seed_sweep, compact.label_rank_fused
        calls[str(root)] = {
            "K2": lambda f=fused: f(fg, RANK_SWEEPS),
            "K2 dense": lambda f=fused: f(dense, RANK_SWEEPS),
            "K5": lambda f=sweep: f(k5_in, fg_s, 4, P),
            "K3": lambda f=local: f(k3_in, fg_s, cfg.ccl_max_iters, P),
            "K4": lambda f=rank: f(k4_in, RANK_SWEEPS),
        }
        for name, fn in calls[str(root)].items():
            got = outputs(fn())
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, plain[name])):
                print(f"time_ccl_slow: {name} of {root} disagrees with the plain version",
                      file=sys.stderr)
                return 1
    trees = list(calls)
    result = {"card": card, "frames": int(fg_s.shape[0]), "reps": args.reps, "ms": {}}
    for name in ("K5", "K4", "K3", "K2", "K2 dense"):
        for way, timer in (("queued", chip_smoke.time_ms), ("back_to_back", back_to_back_ms)):
            samples = {t: [] for t in trees}
            for t in trees + trees[::-1]:
                samples[t].append(timer(torch, calls[t][name], args.reps))
            for t in trees:
                ms = sum(samples[t]) / len(samples[t])
                result["ms"].setdefault(name, {}).setdefault(way, {})[t] = ms
                print(f"{name} {way} {t}: {ms:.4f} ms ({', '.join(f'{v:.4f}' for v in samples[t])}) "
                      f"[{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
