#!/usr/bin/env python3
r"""Time the port's kernels (K1-K6, T1) of trees of the port on the same
inputs, on one GPU.

    python3 tools/time_kernels.py [--trees DIR ...] [--reps 20] [--kernels NAME ...]
                                  [--t1-split]

Each DIR is the root of a checkout of this repository (default: this one),
for example an earlier commit unpacked with `git archive` into a
git-ignored directory.  Its `swiftwatcher_tpu_torch` is imported under a
name of its own and builds its kernels into its own `build/kernels/`.

The inputs are chip_smoke.py's: one batch (16 x 21 frames) of the 1080p
bench scene with a dark 64 x 64 block crossing the crop, through this
tree's RPCA.  K1 runs on the batch's motion (336, 216, 432), and "K1 zeros"
on an all-zero batch of that shape, where every block takes the quiet path
(the streaming floor).  K6 runs at (16, 21, 93312) on the state after 3
plain cold-start iterations of the batch (chip_smoke.k6_state: u8 X, bf16
A and Y).  K2 runs on the batch's foreground after K1, and on as many
frames of dense speckle (chip_smoke.DENSE_DENSITY).  K3-K5 run on the
frames K2 flags, with the planes the slow path hands each: K5 (4 sweeps)
K2's swept labels, K3 the labels after K5's 24-sweep budget, K4 the
converged labels.  T1 (the device tracker's scan) runs on the batch's
compacted region tables (336 frames, K = 24), "T1 dense" and "T1 sparse"
on chip_smoke.fuzz_tables streams of as many frames with 0-30 and 0-4
segments a frame, and "T1 empty" on chip_smoke.empty_stretch_tables (busy
runs between runs of 50-70 empty frames, an empty run at the edge); trees
without the device tracker skip them.  Every tree's outputs are checked
against this tree's plain versions: bit-equal, except K6's G, within 1e-4
of max|G|.

Each kernel of each tree is timed in two ways, in turns over the trees
(A, B, B, A for two): queued behind a spin (chip_smoke.time_ms, device
time) and back to back without one (which includes the host's dispatch of
each call when that takes longer than the kernel).  This tree's K6 is also
timed in parts: "K6 stream" is the same launch without the Gram (E and M
only), and "K6 grid x2" the kernel with twice the blocks per SM in its
grid.  Prints the card's name and power limit, a line per kernel, tree and
way, and last one JSON object of all the times.  Imports the port only (no
JAX).  Needs a CUDA device.

--t1-split builds each tree's T1 a second time with -DT1_SPLIT, which
compiles in clock64() stamps at its phase boundaries (trees whose T1 has
none are skipped), runs it on each T1 stream, and prints the kernel's
counts (frames by kind, JV rows, Dijkstra steps, events), its SM cycles
per phase, and the time of T1a alone (queued, this build).  Only this
build has the stamps.  The one-block T1 that the two-kernel design
replaced (commit 4e931d5 and before) gets the same stamps, and a split
build, from tools/t1_split_one_block.patch; its default build is
unchanged, so one patched tree gives both its times and its split:

    git archive 4e931d5 | tar -x -C DIR
    patch -p1 -d DIR < tools/t1_split_one_block.patch
    python3 tools/time_kernels.py --trees DIR . --t1-split \
        --kernels T1 "T1 dense" "T1 sparse" "T1 empty"
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
from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter_reference  # noqa: E402
from swiftwatcher_tpu_torch.ops.ialm_front import ialm_front_reference  # noqa: E402
from swiftwatcher_tpu_torch.ops.rank_compact import (  # noqa: E402
    RANK_SWEEPS,
    label_rank_fused_reference,
    rank_seed_sweep_reference,
)
from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched  # noqa: E402

KERNELS = ("K1", "K1 zeros", "K6", "K5", "K4", "K3", "K2", "K2 dense", "T1", "T1 dense",
           "T1 sparse", "T1 empty")
PARTS = ("K6 stream", "K6 grid x2")


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


def agrees(name, got, want) -> bool:
    """Bit-equal outputs; K6's G (its third output) within
    chip_smoke.G_RTOL of max|G|."""
    if name.startswith("K6"):
        (e, m, g), (e0, m0, g0) = got, want
        return (torch.equal(e, e0) and torch.equal(m, m0)
                and chip_smoke.f32_err(g, g0) <= chip_smoke.G_RTOL * float(g0.abs().max()))
    return all(torch.equal(g, w) for g, w in zip(got, want))


def t1_outputs(out):
    """T1's (state, events) as one tuple of tensors."""
    return tuple(getattr(part, f) for part in out for f in vars(part))


def t1_inputs(dev, cfg, bench, gray):
    """{name: track_window's arguments} for T1 on the batch's compacted
    tables and on two fuzz streams of as many frames."""
    from swiftwatcher_tpu_torch.geometry import roi_crop_region_from_corners
    from swiftwatcher_tpu_torch.ops.roi_mask import generate_roi_mask
    from swiftwatcher_tpu_torch.pipeline.tracking_device import compact_tables, empty_state
    from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

    K, N = cfg.max_tracks, gray.shape[0] * gray.shape[1]
    roi = generate_roi_mask(bench.frames[0], roi_crop_region_from_corners(bench.corners, cfg),
                            crop_region_from_corners(bench.corners, cfg), cfg, device=dev)
    fns = torch.arange(N, dtype=torch.int32, device=dev)
    act = torch.ones(N, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(11)
    tables = {"T1": localize_windows_gray(gray, cfg)[0]}
    for name, most in (("T1 dense", 30), ("T1 sparse", 4)):
        tables[name] = chip_smoke.fuzz_tables(np, torch, rng, N, *gray.shape[2:], most, dev)
    tables["T1 empty"] = chip_smoke.empty_stretch_tables(np, torch, rng, N, *gray.shape[2:], dev)
    args = {}
    for name, table in tables.items():
        cy, cx, valid, _ = compact_tables(table, K)
        args[name] = (empty_state(K, dev), roi, cy.reshape(N, K).contiguous(),
                      cx.reshape(N, K).contiguous(), valid.reshape(N, K).contiguous(),
                      fns, cfg, act)
    return args


def t1_split(port, t1, plain, card, result, reps: int = 3) -> bool:
    """The -DT1_SPLIT build of `port`'s T1 on each T1 stream: its counts
    and cycles per phase (mean of `reps` runs), printed and kept in
    result["t1_split"]; False if its outputs differ from the plain
    version's."""
    td = importlib.import_module(f"{port.__name__}.pipeline.tracking_device")
    if not hasattr(td, "STAT_NAMES"):
        print(f"t1-split: {port.__file__}: its T1 has no stamps", flush=True)
        return True
    for name, a in t1.items():
        runs = []
        for _ in range(reps):
            stats = torch.zeros(len(td.STAT_NAMES), dtype=torch.int64, device=a[2].device)
            out = t1_outputs(td.scan_cuda(*a, stats=stats, defines=("T1_SPLIT",)))
            if not agrees(name, out, plain[name]):
                print(f"time_kernels: the split build of {name} disagrees with the plain "
                      f"version", file=sys.stderr)
                return False
            runs.append(stats.cpu().numpy())
        mean = np.mean(runs, axis=0)
        split = {k: float(v) for k, v in zip(td.STAT_NAMES, mean)}
        if hasattr(td, "track_prologue"):
            split["T1a ms"] = chip_smoke.time_ms(
                torch, lambda a=a: td._launch(*a, prologue_only=True), 10)
        result.setdefault("t1_split", {}).setdefault(name, {})[str(Path(
            port.__file__).parent.parent)] = split
        print(f"t1-split {name} {Path(port.__file__).parent.parent}: " + ", ".join(
            f"{k} {v:.4f}" if k.endswith("ms") else f"{k} {v:.0f}" for k, v in split.items())
            + f" [{card}]", flush=True)
    return True


def inputs(dev, cfg):
    """K1's motion, K6's state, the CCL kernels' and T1's inputs for one
    batch of the close-pass scene (see the module's docstring)."""
    bench = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    frames = chip_smoke.close_pass(np, bench.frames)
    bench.frames = frames
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    B, T = cfg.batch_windows, cfg.window_size
    gray = bgr_to_gray_host(frames[np.arange(B * T) % len(frames), y1:y2, x1:x2])
    H, W = gray.shape[1:]
    gray = torch.from_numpy(gray.reshape(B, T, H, W)).to(dev)
    t1 = t1_inputs(dev, cfg, bench, gray)
    motion, _ = rpca_motion_window_batched(gray, cfg)
    motion = motion.reshape(B * T, H, W).contiguous()
    k6 = chip_smoke.k6_state(torch, gray, cfg)
    fg = (fused_motion_filter_reference(motion, cfg) > 0).contiguous()
    lbl, _, flag = label_rank_fused_reference(fg, RANK_SWEEPS)
    slow = flag.nonzero().flatten()
    P = float(H * W)
    fg_s, k5_in = fg[slow].contiguous(), lbl[slow].contiguous()
    k3_in = sweep_chunk_reference(k5_in, fg_s, 24, P)[0]
    k4_in = converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P)
    dense = torch.from_numpy(np.random.default_rng(5).random(tuple(fg.shape))
                             < chip_smoke.DENSE_DENSITY).to(dev)
    return motion, k6, fg, dense, k5_in, k3_in, k4_in, fg_s, P, t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, default=[ROOT])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS + PARTS,
                    help="kernels to time (default: all; this tree's K6 parts "
                         "are timed whenever K6 is)")
    ap.add_argument("--t1-split", action="store_true",
                    help="also run each tree's T1 built with its phase stamps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    cfg = DEFAULT_CONFIG
    dev = require_cuda()
    pin_numerics()
    card = chip_smoke.gpu_line()
    print(card, flush=True)
    motion, k6, fg, dense, k5_in, k3_in, k4_in, fg_s, P, t1 = inputs(dev, cfg)
    zeros = torch.zeros_like(motion)
    print(f"inputs: K1 on {tuple(motion.shape)}, K6 at {tuple(k6[0].shape)} "
          f"({k6[0].dtype} X, {k6[1].dtype} A and Y), K2 on {tuple(fg.shape)}, K3-K5 on the "
          f"{fg_s.shape[0]} frames K2 flags in one batch of the close-pass scene", flush=True)
    plain = {
        "K1": (fused_motion_filter_reference(motion, cfg),),
        "K1 zeros": (zeros,),
        "K6": ialm_front_reference(*k6),
        "K2": label_rank_fused_reference(fg, RANK_SWEEPS),
        "K2 dense": label_rank_fused_reference(dense, RANK_SWEEPS),
        "K5": sweep_chunk_reference(k5_in, fg_s, 4, P),
        "K3": (converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P),),
        "K4": rank_seed_sweep_reference(k4_in, RANK_SWEEPS),
    }
    if any(k.startswith("T1") for k in args.kernels):
        from swiftwatcher_tpu_torch.pipeline.tracking_device import track_window_reference

        plain.update({k: t1_outputs(track_window_reference(*a)) for k, a in t1.items()})
    plain["K6 grid x2"] = plain["K6"]
    calls = {}
    ports = [load_port(root, f"swt_tree{i}") for i, root in enumerate(args.trees)]
    for root, port in zip(args.trees, ports):

        def op(module, name, port=port):
            return getattr(importlib.import_module(f"{port.__name__}.ops.{module}"), name)

        fused, front = op("fused_motion", "fused_motion_filter"), op("ialm_front", "ialm_front")
        sweep, local = op("ccl_sweep", "sweep_chunk"), op("ccl_local", "converge_frames")
        rank, label = op("rank_compact", "rank_seed_sweep"), op("rank_compact", "label_rank_fused")
        calls[str(root.resolve())] = {
            "K1": lambda f=fused: f(motion, cfg),
            "K1 zeros": lambda f=fused: f(zeros, cfg),
            "K6": lambda f=front: f(*k6),
            "K2": lambda f=label: f(fg, RANK_SWEEPS),
            "K2 dense": lambda f=label: f(dense, RANK_SWEEPS),
            "K5": lambda f=sweep: f(k5_in, fg_s, 4, P),
            "K3": lambda f=local: f(k3_in, fg_s, cfg.ccl_max_iters, P),
            "K4": lambda f=rank: f(k4_in, RANK_SWEEPS),
        }
        try:
            scan = importlib.import_module(
                f"{port.__name__}.pipeline.tracking_device").track_window
        except ImportError:            # a tree from before the device tracker
            scan = None
        if scan is not None and any(k.startswith("T1") for k in args.kernels):
            calls[str(root.resolve())].update({
                name: lambda f=scan, a=a: t1_outputs(f(*a)) for name, a in t1.items()})
    here = calls.get(str(ROOT))
    if here is not None:
        from swiftwatcher_tpu_torch.ops import ialm_front as k6_mod

        def grid_x2():
            blocks = k6_mod._BLOCKS_PER_SM
            k6_mod._BLOCKS_PER_SM = 2 * blocks
            try:
                return k6_mod.ialm_front(*k6)
            finally:
                k6_mod._BLOCKS_PER_SM = blocks

        here["K6 stream"] = lambda: k6_mod.launch_front("swt_ialm_front_stream", *k6)
        here["K6 grid x2"] = grid_x2
    result = {"card": card, "frames": int(fg_s.shape[0]), "reps": args.reps, "ms": {}}
    if args.t1_split:
        if not all(t1_split(port, t1, plain, card, result) for port in ports):
            return 1
    for t, fns in calls.items():
        for name, fn in fns.items():
            got = outputs(fn())
            torch.cuda.synchronize()
            if name == "K6 stream":
                ok = all(torch.equal(g, w) for g, w in zip(got[:2], plain["K6"][:2]))
            else:
                ok = agrees(name, got, plain[name])
            if not ok:
                print(f"time_kernels: {name} of {t} disagrees with the plain version",
                      file=sys.stderr)
                return 1
    wanted = list(args.kernels)
    if "K6" in wanted:
        wanted += [k for k in PARTS if k not in wanted]
    for name in wanted:
        trees = [t for t in calls if name in calls[t]]
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
