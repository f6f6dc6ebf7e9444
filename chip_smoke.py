#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from swiftwatcher_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, and drives the counting main
path (`run_video`) end to end:

  1. the card's name and power limit (nvidia-smi);
  2. kernel build time;
  3. K1 (fused motion filter) vs the plain chain at (336, 216, 432), on RPCA
     motion of the 1080p scene plus block-boundary and halo-edge cases, and
     on other shapes and settings (ragged blocks, radii 1-4, a frame wider
     than a block, 0/255 checkerboards, lone pixels under flat weights):
     bit-equal; its hot-block count and the share of their pixels the
     window-max skip leaves out;
  4. K2 (fused CCL) vs its plain version: swept labels, compact labels and
     flags bit-equal, on that motion plus a snake and a dense speckle, on
     all-foreground and empty frames and shapes that are not a multiple of
     its tile; its time on that motion and on 336 dense speckle frames;
     then the slow-path kernels on the frames K2 flags, each vs its plain
     version at the planes the slow path hands it, bit-equal on every
     output: K5 (sweep chunk and its "changed" flag) with 1, 4 and 8
     sweeps on K2's swept labels, on the rank plane, on a background below
     the sentinel, on all-foreground and empty frames, a frame touching all
     four edges and at 47 x 121, 1 x 500 and 300 x 1, its flag false on
     settled frames and true on unsettled ones; K4 (rank compaction and its
     "unsettled" flag) with 0, 1, 12 and 32 sweeps on the converged labels
     of the close-pass frames, of the snake + speckle pair and of the dense
     batch; K3 (whole-frame convergence) on the labels after K5's sweep
     budget and on the rank plane, with max_iters 0, on the edge frame and
     the 1-row and 1-column shapes.  K3-K5 are timed apart on the
     close-pass frames (those the main path meets), K3 also on the snake +
     speckle pair; label_components on the card equals it on the CPU;
  5. run_video on the small synthetic scene on the card and on the CPU:
     equal events, 2 predicted and 1 rejected;
  6. run_video over 1008 frames of the 1080p scene (216 x 432 crop):
     events > 0, and each of K1-K5 and K7 launched on that run, K7 once a
     trip and once a batch (the sum over batches of the slowest window's
     iterations + 1), in as many `ialm_eigh` spans and no `sync.ialm_eigh`
     (no refined eigh on the synchronising plain chain);
  7. K6 (fused IALM front) vs its plain version at (16, 21, 93312) on the
     state of a real cold-start iteration of one batch of that scene (u8
     X, bf16 A and Y, as the solver holds them), the same state widened to
     f32, and ragged shapes (T 1 to 32, P 1 to 93312): E and M bit-equal, G
     within 1e-4 max|G|, and bit-identical in two calls on the main state;
  8. cold-start RPCA on that batch on the card with K6 vs with the plain
     front: iterations within 1, motion within 2 u8; the warm solve beside;
  9. run_video over the 1008 frames with rpca_warm_basis=False: every
     kernel K1-K7 launched, no `sync.ialm_eigh`, and the predicted and
     rejected counts of 6;
 10. the CLI (`swiftwatcher_tpu_torch.__main__.main`) on the card with
     rpca_warm_basis=False and its default device tracker on the small
     scene as a .npy clip: 2 predicted / 1 rejected, and six CSVs
     byte-equal to run_video with the device tracker on the CPU;
 11. T1 (the device tracker's scan, csrc/track_scan.cu: T1a, the prologue
     over all frames, then T1b, the frame chain in one warp) vs its plain
     version at track_enum_lap 0, 4 and 6, on the compacted tables of the
     close-pass batch, on seeded K = 24 streams (0-30 segments a frame:
     enumeration and JV frames, up to 24 live tracks, compact_tables
     overflow frames, an inactive tail, and an event-buffer overflow), a
     K = 64 stream of 0-60 segments (4 columns a lane), a K = 33 stream (66
     columns) and a stream of busy runs between runs of 50-70 empty frames
     (one at the batch edge): state, events, count and overflow bit-equal,
     and T1a's records bit-equal to track_prologue_reference; the dense
     and the empty-stretch streams' states carried into a second launch;
     the latency of one dependent warp argmin (both forms) and of a shared
     load and a ballot, from micro-kernels (csrc/t1_latency.cu); T1's time on each stream beside
     its latency bound (frames with work x the latter + Dijkstra steps and
     enumeration argmins x the former), and on the close-pass batch beside
     the plain version's and the host SegmentTracker's; then run_video
     over the 1008 frames with tracker_impl="device": one call per batch,
     two kernels a call as the launcher counts them, K1 and K2 launched,
     K7 launched and counted as in phase 6 (this run's count is K7's
     `launches` in the kernels line), and events equal to phase 6's (frame numbers,
     centroids within 1e-3) with the same totals;
 12. --classify and --export: the PIL-exact preprocess on the card
     bit-equal to the CPU at 100 crop sizes; the SqueezeNet forward on the
     card vs the CPU on the close-pass batch's crops and on seeded canvases
     (max |logit diff|, smallest margin, equal argmaxes), with TF32 turned
     on by the caller and found off at every forward; its time and the
     preprocess's per batch; run_video on the small scene with two weight
     sets that reject part of its segments, card == CPU on the host
     tracker and on the device tracker fused and unfused; run_video
     --classify over the 1008 frames with the shipped weights on those
     three paths (K1-K5 launched, T1 once a batch on the device tracker,
     no host sync inside the fused classify-then-track call, events equal
     to each other and to phase 11's), with frames/s, the classify stage
     seconds, peak device memory, peak host RSS and the classifier's upload
     bytes; and the CLI with --classify --export on the card with the
     device tracker (T1 launched): six CSVs and the PNGs byte-equal to the
     host tracker's on the CPU;
 13. real containers at 1080p: the close-pass clip (504 frames, a batch and a
     half; 1008 would add about 25 s to the script) written as
     an MJPG AVI and an mp4v MP4 by cv2, and as an H.264 MP4 by the port's
     write_test_video where libx264 is built; the CLI with its device
     tracker on each file through `auto` and every decode backend that
     engages there (native, parallel, av, cv2, forced by patching the
     CLI's open_source; auto and cv2 must run on every file, native and av
     wherever their library is built, parallel wherever cv2's seek is
     exact), printing source.backend, decode_workers, frames/s
     (and the source's own frames/s, read alone), the
     prefetch_wait/localize/consume seconds and the launches of K1, K2
     and T1; the six CSVs byte-equal across one file's backends; and a
     checkpoint resume on the parallel MP4 equal to the full run;
 14. the flags: --profile on the small scene (trace.json names the C
     launchers of K1, K2 and T1 and, where the profiler traced the card,
     holds their kernels; the manifest has the localize and track_scan
     device seconds) and a profiled 1080p run beside phase 11's frames/s;
     --parallel-videos 2 on two clips, also with --profile (a trace from
     the run that held the profiler, device times from both), CSVs
     byte-equal to two sequential runs; stabilize_window (J = 3) on one bench batch shaken by
     planted integer shifts, card == CPU bit for bit; --accuracy-pack on the
     accuracy corpus's jitter2 scene (make_hard_video), card == CPU;
     opening an .h5 without h5py raises an ImportError that names h5py and
     the alternatives;
 15. --mesh (parallel/mesh.py): a (1, 1) mesh on NCCL, and (1, 2) and (2, 1)
     meshes on gloo with both ranks on the one card: the first batch's
     sharded tables equal the unsharded localize_windows_gray's (IALM
     iterations within 1); run_video over the 1008 frames on each, warm,
     and cold on (1, 2), with the device tracker: events equal phase 11's
     (phase 9's cold), every rank launched K1 and K2 (and K6 cold), with
     frames/s, the backend and each rank's seconds in collectives per
     batch; sharded_train_step on (1, 2) against one process's step on the
     card (losses within 1e-5, head within 1e-6); the CLI with --mesh 1x1
     gives the CSVs of the CLI without it, and --mesh 2x1 on one card is
     refused with the JAX CLI's message; finetune on the card against the
     CPU (head within 1e-6);
 16. the last modules: the wire codec (io/wirecodec.py) on the close-pass
     batch (336 x 216 x 432) as delta4 and delta6 with each predictor
     forced, decoded on the card bit-equal to the raw batch; an i.i.d.-noise
     batch over both escape caps shipped raw by the prefetcher; auto's link
     probe (its rate and its decision: raw on the card, and phase 6 shipped
     raw bytes); the CLI over phase 6's 1008 frames raw, with delta6 and
     delta4 (escape cap raised so the close-pass batches fit) and with
     delta6 at the default cap (every batch overflows and ships raw):
     phase 6's events and six CSVs byte-equal to the raw run's; decode ms
     a batch on the card, encode ms a batch on the host (the C twin and
     numpy) and wire bytes a frame; ialm_rpca on one 216 x 432 x 21 window
     in f64 on the card, the device solver against the host_svd oracle
     (equal iterations, A and E within 1e-6); localize_window_debug's
     opened plane bit-equal to K1 on its RPCA plane; and three scenes of
     the accuracy corpus (crowded, jitter2, flyby_trap) through
     tools/torch_accuracy_corpus.py, card == CPU in totals and event
     frames;
 17. bench_torch.py, the port's benchmark, in a process of its own at cut
     sizes (672 frames a sample, the resident and sharded modes at 1344
     frames, the container at 4 loops of the bench scene, mp4v here):
     both of its lines parse, every rate of its stdout line is positive
     (from-container included), the from-container counts equal an
     ArraySource run over the decoded frames, it found events, its
     predicted and rejected equal a host-tracker run_video on the card over
     the same frames, and K1, K2 and T1 launched in its end-to-end and
     resident-tracked modes; then tools/torch_soak.py for two passes of two
     loops at 1080p: the counts scale exactly, with host RSS and device
     memory after each pass;
 18. the campaign and measurement tools, in this process:
     tools/torch_rpca_fixed_counts.py on 4 parity-fuzz scenes (device and
     host trackers in turn): no mismatch between dynamic stopping and
     rpca_fixed_iters=15, the dynamic counts of scenes 0 and 1 equal to
     run_video on the CPU, K1, K2 and T1 launched;
     tools/torch_bench_rpca.py on 16 windows of the 216 x 432 crop (P =
     93312), production, warm and cold: ms per IALM trip by the host clock
     and by CUDA events beside one f32 pass's byte floor, trips within
     rpca_max_iter, K6 not launched; tools/torch_mesh_scaling.py at sizes 1
     and 2 ((1, 1) on NCCL, two ranks on gloo sharing the card): every
     point positive, K1 and K2 launched on rank 0;
     tools/torch_decode_floor.py on 63 frames: exit 2 with its error line
     where the port's libav library is not built (the card's machine),
     else the four modes' rates; tools/torch_accuracy_seed_sweep.py at one
     seed of crowded and jitter2: both scored, and the AVG block;
 19. K7 (csrc/refined_eigh.cu, the refined eigendecomposition) vs
     refined_eigh_reference on the Grams of every refined eigh of a warm
     solve of phase 3's batch (the seed's and each trip's C, captured
     from the plain chain) and on synthetic Grams (random SPD, clustered
     spectra, u8 windows at the 93312-pixel crop, rank 1, all zero):
     against numpy's f64 eigh, ||V^T V - I||, ||G V - V diag d|| / ||G||
     and the eigenvalues within 1e-5 (the residual within 1e-2 on rank 1,
     where the plain chain's Newton steps lose it too), the eigenvectors
     of separated eigenvalues within a sin of 1e-3 of the plain chain's,
     bit-identical in two launches; the sweeps taken (largest, median);
     the warm solve with K7 (and K8) against the plain chain (the Grams
     above come from it, with K8 off; iterations within 1,
     motion within 2 u8, one launch a trip and the seed's); K7's time and
     the plain chain's at (16, 21, 21) and (64, 21, 21) beside K7's
     latency bound (its barrier rounds x one round's ns, from the
     micro-kernel of csrc/k7_latency.cu);
 20. K8 (csrc/ialm_trip.cu, the warm IALM trip's two kernels) vs
     ialm_trip_reference at the cells' (64, 21, 93312), u8 X and bf16
     state, on the states of a warm solve's trips (the second, the middle
     and the last, captured from the plain chain): E's store bit-equal, C,
     each window's sum of Z^2 and the bf16 stores of A and Y within
     ops/ialm_trip.py's tolerances, bit-identical in two runs; frozen
     windows untouched; the whole solve on K8 against the plain chain
     (iterations within 1, motion within 2 u8, one K8 trip a loop trip);
     K8a's and K8b's times beside their byte bound, the trip's (with K7
     and the T x T work) beside the plain trip's; run_video at a batch of
     64 windows: ialm_trip.launches equal to its `ialm_trip` spans and to
     its trips.  `chip_smoke.py --phase 20` runs phases 1, 2 and 20 alone.

The 1080p scene is the bench scene (make_video at 1080 x 1920) with a
large bird passing close to the camera in 4 frames of its 63: a 64 x 64
blob, deeper than the fast path's sweeps, so those frames take the CCL
slow path and its kernels run on the main path.

Prints kernel and end-to-end times on the way, then a {"kernels": [...]}
line, the card line again, and last {"ok": true, "device": {...}}.  Kernel
times are device times by CUDA events (`time_ms`: the calls are queued
behind a spin, so the host's dispatch is not timed).  Each
kernel's `bound_ms` is the larger of the bytes it must move (each input
read once, each output written once) over the card's memory rate and the
operations it does on this run's inputs over the f32 rate (`bound`); T1 is
bound by neither but by the latency of its frame chain, which its entry
gives as `latency_bound_ms` (phase 11), beside `kernels_per_launch` (the
kernels its launcher counted over the main path's calls, per call); K7 is
bound by the latency of its barrier rounds (phase 19); K8's `ms` is its
two kernels' (phase 20).  No single PyTorch call computes any of K1-K8 or
T1, so `library_ms` is null.  Exits
nonzero, printing no result, on any failure or when no CUDA device exists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

TOL = 0  # every comparison below is bit-equal, except K6's Gram
G_RTOL = 1e-4  # K6's G vs plain, relative to max|G|: another summation order

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and f32 non-tensor ops/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Cycles per second that turn a spin's seconds into torch.cuda._sleep's
# cycles: the H100's highest SM clock (1980 MHz) rounded up, so a spin
# lasts at least as long as asked.
SPIN_CYCLES_PER_S = 2.0e9


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


def time_ms(torch, fn, reps: int = 10, what: str = "") -> float:
    """Mean device milliseconds per call, by CUDA events, after a warm-up.

    The events bracket the calls on the device alone: a spin kernel
    (torch.cuda._sleep) queued first holds the stream while the host queues
    the start event, the calls and the stop event, so the device runs them
    back to back and the host's dispatch of each call (output allocation,
    checks, ctypes) is not timed.  The spin lasts twice the host's time to
    queue the calls, measured on a pass before, plus 1 ms.  With `what`, a
    line is printed if the device ran dry anyway (the start event had
    completed by the time the stop event was queued): then the time
    includes dispatch gaps.  A function that synchronises inside is timed
    with its host waits."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s + 1e-3, 2.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    ran_dry = start.query()
    torch.cuda.synchronize()
    if ran_dry and what:
        print(f"time_ms: the device ran dry while {what} was queued; its time "
              f"includes dispatch", flush=True)
    return start.elapsed_time(stop) / reps


def alternate_ms(torch, plain, kernel, reps: int = 10, what: str = "the kernel"):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps, what)
    k2 = time_ms(torch, kernel, reps, what)
    p2 = time_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def boundary_motion(np, H: int, W: int) -> "np.ndarray":
    """Frames that probe K1's block edges and its early-outs: empty, all at
    the threshold, all above it, and 3 x 3 bright blobs on sub-threshold
    noise at and around every 24- and 32-row band seam and 64-column seam
    (K1's blocks are 24 x 128, an earlier design's 32 x 64), the frame
    border, and the halo edges of each block (radius + 2 = 5 rows or
    columns outside it); every other frame's blobs are 255 (|d| = 255
    against the noise)."""
    rng = np.random.default_rng(7)
    frames = [
        np.zeros((H, W), np.uint8),
        np.full((H, W), 15, np.uint8),
        np.full((H, W), 16, np.uint8),
    ]
    near = (-5, -3, -2, -1, 0, 1, 2, 4)
    rows = sorted({s + d for s in (*range(0, H + 1, 24), *range(0, H + 1, 32))
                   for d in near if 0 <= s + d < H} | {H - 3, H - 1})
    cols = sorted({s + d for s in range(0, W + 1, 64) for d in near if 0 <= s + d < W}
                  | {W - 3, W - 1})
    for i in range(0, len(rows), 2):
        m = (rng.random((H, W)) * 14).astype(np.uint8)
        for r in rows[i : i + 2]:
            for c in cols:
                m[r : r + 3, c : c + 3] = 255 if i % 4 else 120
        frames.append(m)
    return np.stack(frames)


# K1 shapes and settings beyond the main path's: ragged blocks, frames
# smaller than a block, other bilateral radii and thresholds, and weights
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
    ((2, 40, 1100), {}),
)


def k1_cases(np, rng):
    """(what, frames, config overrides) for K1 beyond the main path: blob
    motion at K1_EXTRA's shapes and settings, 0/255 checkerboards (|d| =
    255 at every tap), and lone 255 pixels under flat colour and space
    weights, where the bilateral lifts every pixel of the window's edge
    above the threshold (a window-max skip one row or column short fails
    there)."""
    cases = [(f"{shape} {ov or 'default'}", blob_motion(np, rng, shape), ov)
             for shape, ov in K1_EXTRA]
    yy, xx = np.indices((70, 300))
    checker = np.stack([(yy + xx) % 2, (yy // 3 + xx // 5) % 2]).astype(np.uint8) * 255
    cases.append(("0/255 checkerboards (70, 300)", checker, {}))
    lone = np.zeros((2, 70, 300), np.uint8)
    lone[:, rng.integers(0, 70, 40), rng.integers(0, 300, 40)] = 255
    cases.append(("lone 255 pixels, flat weights", lone,
                  {"bilateral_sigma_color": 1e7, "bilateral_sigma_space": 10.0,
                   "motion_threshold": 5}))
    return cases


# K2 shapes beyond the main path's, with a foreground density each.
K2_EXTRA = (((4, 47, 121), 0.3), ((2, 1, 500), 0.5), ((2, 300, 1), 0.5),
            ((3, 64, 64), 0.7), ((2, 216, 432), 1.0), ((2, 216, 432), 0.0),
            ((3, 100, 200), 0.5))
# The dense batch K2 is also timed on: speckle at snake_frames' density.
DENSE_DENSITY = 0.38


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


def bound(n_bytes: float, n_ops: float):
    """(least ms, "bytes" or "operations") for moving n_bytes through HBM
    and doing n_ops f32 operations on one H100."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_work(torch, motion, cfg):
    """What K1's design does on `motion`: (bound, hot blocks, blocks, share
    of the hot blocks' pixels that the window-max skip leaves out).

    A block (24 x 128 output pixels) is hot when its input with a halo of
    radius + 2 holds a pixel above the threshold; in a hot block the tap
    loop runs on the pixels whose (2r+1)^2 window does.  K1 moves the u8
    frames in and out once; its arithmetic is the bilateral (29 taps of ~8
    operations at radius 3) on those pixels and ~24 byte operations a
    pixel of a hot block (window max, opening)."""
    import torch.nn.functional as F

    from swiftwatcher_tpu_torch.ops.filtering import bilateral_constants
    from swiftwatcher_tpu_torch.ops.fused_motion import BLOCK

    N, H, W = motion.shape
    radius, space, _ = bilateral_constants(
        cfg.bilateral_d, cfg.bilateral_sigma_color, cfg.bilateral_sigma_space)
    above = (motion > cfg.motion_threshold).float()[:, None]
    near = F.max_pool2d(above, 2 * radius + 5, stride=1, padding=radius + 2)[:, 0]
    window = F.max_pool2d(above, 2 * radius + 1, stride=1, padding=radius)[:, 0]
    (bh, bw), (ph, pw) = BLOCK, (-H % BLOCK[0], -W % BLOCK[1])
    blocks = F.pad(near, (0, pw, 0, ph)).reshape(N, (H + ph) // bh, bh, (W + pw) // bw, bw)
    hot = blocks.amax(dim=(2, 4)) > 0
    in_hot = hot.repeat_interleave(bh, 1).repeat_interleave(bw, 2)[:, :H, :W]
    hot_px = int(in_hot.sum())
    taps_px = int((window.bool() & in_hot).sum())
    skipped = 1.0 - taps_px / hot_px if hot_px else 0.0
    n_ops = taps_px * len(space) * 8 + hot_px * 24
    return bound(2 * motion.numel(), n_ops), int(hot.sum()), hot.numel(), skipped


def k6_bytes_ops(X, A, Y):
    """K6 reads X, A, Y and inv_mu once and writes E, M (f32) and G; it
    does ~10 operations an element and the Gram's 2 T^2 P per window."""
    B, T, P = X.shape
    n = X.numel()
    n_bytes = (n * (X.element_size() + A.element_size() + Y.element_size() + 8)
               + B * T * T * 4 + B * 4)
    return n_bytes, 10 * n + 2 * B * T * T * P


def k6_state(torch, gray, cfg):
    """K6's operands (X, A, Y, inv_mu, lmbda) on the card after 3 plain
    cold-start IALM iterations of the (B, T, H, W) u8 batch `gray`, as the
    solver holds them (u8 X, bf16 A and Y)."""
    import dataclasses

    from swiftwatcher_tpu_torch.ops import ialm_trip as k8_mod
    from swiftwatcher_tpu_torch.ops import rpca as rpca_mod

    B, T, H, W = gray.shape
    X = gray.reshape(B, T, H * W).to(torch.float32)
    kw = rpca_mod.ialm_gates_and_kwargs(
        dataclasses.replace(cfg, rpca_warm_basis=False), torch.float32, X.device)
    check(kw["fused_front"] and not kw["warm_basis"], "the cold gate did not pick K6 on the card")
    calls = []
    plain_front = k8_mod.ialm_front_reference

    def recording_front(*args):
        calls.append(args)
        return plain_front(*args)

    k8_mod.ialm_front_reference = recording_front
    try:
        rpca_mod.ialm_rpca_batched(X, **dict(kw, fused_front=False, fixed_iters=4))
    finally:
        k8_mod.ialm_front_reference = plain_front
    return calls[-1]


def fuzz_tables(np, torch, rng, T: int, H: int, W: int, most: int, dev):
    """A (T, 256) region table of max(30, `most`) blobs moving a few pixels
    a frame (labels 1 + 8 k for 30 of them, spaced 255 // n apart for more),
    0 to `most` of them present in each frame, sometimes the first ones and
    sometimes any; frames with more than K overflow compact_tables' K
    slots."""
    from swiftwatcher_tpu_torch.ops.props import RegionTable

    n = max(30, most)
    pos = rng.uniform((0, 0), (H, W), (n, 2))
    vel = rng.uniform(-6, 6, (n, 2))
    valid = np.zeros((T, 256), bool)
    area = np.zeros((T, 256), np.int32)
    sum_y, sum_x = np.zeros_like(area), np.zeros_like(area)
    labels = 1 + (8 if n == 30 else 255 // n) * np.arange(n)
    for t in range(T):
        pos = np.clip(pos + vel, 0, (H - 1, W - 1))
        k = int(rng.integers(0, most + 1))
        on = np.arange(k) if rng.random() < 0.5 else rng.choice(n, size=k, replace=False)
        a = rng.integers(1, 40, k)
        valid[t, labels[on]] = True
        area[t, labels[on]] = a
        sum_y[t, labels[on]] = (pos[on, 0] * a).astype(np.int32)
        sum_x[t, labels[on]] = (pos[on, 1] * a).astype(np.int32)
    zero = torch.zeros((T, 256), dtype=torch.int32, device=dev)
    return RegionTable(
        area=torch.from_numpy(area).to(dev), sum_y=torch.from_numpy(sum_y).to(dev),
        sum_x=torch.from_numpy(sum_x).to(dev), min_y=zero, min_x=zero, max_y=zero,
        max_x=zero, valid=torch.from_numpy(valid).to(dev))


def empty_stretch_tables(np, torch, rng, T: int, H: int, W: int, dev):
    """fuzz_tables with 0-8 segments a frame in busy runs of 10-30 frames
    between empty runs of 50-70 frames; the last run, at the batch edge, is
    empty."""
    table = fuzz_tables(np, torch, rng, T, H, W, 8, dev)
    empty = np.zeros(T, bool)
    t, busy = T, False
    while t > 0:  # from the edge back: empty, busy, empty, ...
        n = int(rng.integers(10, 31) if busy else rng.integers(50, 71))
        empty[max(t - n, 0):t] = not busy
        t, busy = t - n, not busy
    table.valid[torch.from_numpy(empty).to(dev)] = False
    return table


def t1_latencies(torch, build, dev, steps: int = 1 << 16) -> dict:
    """Nanoseconds per step of csrc/t1_latency.cu's micro-kernels
    (one warp, `steps` dependent steps, CUDA events around one launch after
    a warm-up): "argmin" T1b's (value, index) argmin by two __reduce_min_sync,
    "butterfly" the 5-step xor-butterfly, "frame" one shared-memory load and
    one ballot."""
    out = torch.empty(32, dtype=torch.int32, device=dev)
    ns = {}
    for which, name in enumerate(("argmin", "butterfly", "frame")):
        args = ("t1_latency", "swt_t1_latency", dev, which, steps, 0, out.data_ptr())
        build.launch(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        build.launch(*args)
        stop.record()
        torch.cuda.synchronize()
        ns[name] = start.elapsed_time(stop) * 1e6 / steps
    return ns


def t1_latency_bound(stats, lat: dict) -> float:
    """T1's latency bound in ms from its counts (td.STAT_NAMES): every
    frame with work pays one staged load and one ballot, every Dijkstra
    step and enumeration argmin one dependent argmin (the faster of the
    two measured)."""
    t_argmin = min(lat["argmin"], lat["butterfly"])
    return (stats["work frames"] * lat["frame"]
            + (stats["Dijkstra steps"] + stats["enumeration frames"]) * t_argmin) * 1e-6


def track_bound(cys, valids, count: int, n_pats: int):
    """T1's bound on one scan: it reads the (T, K) slots, frame numbers and
    flags once, reads and writes the state, and writes `count` events of 20
    bytes; it evaluates ~40 operations per valid (previous, current) pair
    and, on enumeration frames, n operations per pattern (counted for every
    frame with work, an upper count)."""
    T, K = cys.shape
    v = valids.float()
    pairs = float((v[:-1].sum(1) * v[1:].sum(1)).sum())
    busy = int((v[:-1].sum(1) + v[1:].sum(1) > 0).sum())
    n_bytes = T * K * 9 + T * 5 + 2 * (K * 21 + 4) + 20 * count
    return bound(n_bytes, 40 * pairs + busy * n_pats * 6)


def run() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device (torch.cuda.is_available() is False)")
    from swiftwatcher_tpu_torch import build
    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.__main__ import main as cli_main
    from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
    from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource, open_source
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
    from swiftwatcher_tpu_torch.ops.ialm_front import ialm_front, ialm_front_reference
    from swiftwatcher_tpu_torch.ops.refined_eigh import refined_eigh
    from swiftwatcher_tpu_torch.ops.roi_mask import generate_roi_mask
    from swiftwatcher_tpu_torch.ops.rpca import rpca_motion_window_batched
    from swiftwatcher_tpu_torch.pipeline import tracking_device as td
    from swiftwatcher_tpu_torch.pipeline.runner import frame_centroids, run_video
    from swiftwatcher_tpu_torch.pipeline.tracking import SegmentTracker
    from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray
    from swiftwatcher_tpu_torch.geometry import roi_crop_region_from_corners

    cfg = DEFAULT_CONFIG
    dev = require_cuda()
    pin_numerics()

    # 1. the card
    card = gpu_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    sources = build.KERNEL_SOURCES + build.TOOL_SOURCES
    secs = build.build_all(sources)
    print(f"phase 2 build: {secs:.2f} s for {', '.join(sources)}", flush=True)

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
    k1_bound, hot_blocks, n_blocks, skipped = k1_work(torch, motion, cfg)
    print(f"phase 3 K1 schedule on {tuple(motion.shape)}: {hot_blocks} of {n_blocks} "
          f"blocks hot; the window-max skip leaves out {100 * skipped:.2f}% of their "
          f"pixels", flush=True)
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
    check(int((got[B * T + 3 :] > 0).sum()) > 0, "K1 boundary frames hold no motion")
    rng = np.random.default_rng(11)
    extra = k1_cases(np, rng)
    for what, m, overrides in extra:
        c = dataclasses.replace(cfg, **overrides)
        m = torch.from_numpy(m).to(dev)
        want = fused_motion_filter_reference(m, c)
        err = int((fused_motion_filter(m, c).int() - want.int()).abs().max())
        check(err <= TOL, f"K1 disagrees with the plain chain on {what}")
    print(f"phase 3 K1 vs plain on {len(extra)} other inputs/settings: bit-equal "
          f"({'; '.join(w for w, _, _ in extra)})", flush=True)
    k1_ms, k1_plain_ms = alternate_ms(
        torch,
        lambda: fused_motion_filter_reference(motion, cfg),
        lambda: fused_motion_filter(motion, cfg),
    )
    print(f"phase 3 K1 time at {tuple(motion.shape)}: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) "
          f"[{card}]", flush=True)

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
    dense = torch.from_numpy(
        np.random.default_rng(5).random(tuple(fg_main.shape)) < DENSE_DENSITY).to(dev)
    for a, b in zip(label_rank_fused(dense, RANK_SWEEPS),
                    label_rank_fused_reference(dense, RANK_SWEEPS)):
        check(torch.equal(a, b), "K2 disagrees with its plain version on the dense batch")
    k2_dense_ms, k2_dense_plain_ms = alternate_ms(
        torch,
        lambda: label_rank_fused_reference(dense, RANK_SWEEPS),
        lambda: label_rank_fused(dense, RANK_SWEEPS),
    )
    print(f"phase 4 K2 time on {tuple(dense.shape)} speckle at density {DENSE_DENSITY}: "
          f"kernel {k2_dense_ms:.4f} ms, plain {k2_dense_plain_ms:.4f} ms, bit-equal, "
          f"{int(label_rank_fused(dense, RANK_SWEEPS)[2].sum())} frames flagged [{card}]",
          flush=True)

    # the slow path's kernels on the flagged frames, at the planes it gives them
    slow = fk.nonzero().flatten()
    close = slow < B * T          # the close-pass frames; the rest, the snake pair
    fg_s, P = fg[slow].contiguous(), float(H * W)
    k5_in = lk[slow].contiguous()
    k3_in = sweep_chunk_reference(k5_in, fg_s, 24, P)[0]
    k4_in = converge_frames_reference(k3_in, fg_s, cfg.ccl_max_iters, P)
    check(not sweep_chunk_reference(k4_in, fg_s, 1, P)[1].any(),
          "the plain K3 did not reach the fixpoint")
    r_in = rank_seed_sweep_reference(k4_in, RANK_SWEEPS)[0]
    slow_err = {"sweep_chunk": 0.0, "converge_frames": 0.0, "rank_seed_sweep": 0.0}
    slow_ms = {}

    def outputs_compare(name, got, want, what):
        """Every output of a kernel (planes and flags) bit-equal to its
        plain version's."""
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                slow_err[name] = max(slow_err[name], f32_err(g, w))
            check(torch.equal(g, w), f"{name} disagrees with its plain version on {what}")

    edge = rng.random((2, H, W)) < 0.45
    edge[:, [0, -1], :] = True
    edge[:, :, [0, -1]] = True
    shape_cases = (("a frame touching all four edges", edge),
                   ("1 x 500", rng.random((2, 1, 500)) < 0.5),
                   ("300 x 1", rng.random((2, 300, 1)) < 0.5))
    # K5: the label and rank planes, a background below the sentinel, other
    # shapes; its flag on settled and unsettled frames
    below = torch.where(fg_s, k5_in, torch.from_numpy(
        rng.integers(0, H * W, size=tuple(fg_s.shape)).astype(np.float32)).to(dev))
    for what, x in (("the label plane", k5_in), ("the rank plane", r_in),
                    ("a background below the sentinel", below)):
        for sw in (1, 4, 8):
            outputs_compare("sweep_chunk", sweep_chunk(x, fg_s, sw, P),
                            sweep_chunk_reference(x, fg_s, sw, P), f"{what}, {sw} sweeps")
    for what, f in (("all-foreground frames", np.ones((2, H, W), bool)),
                    ("empty frames", np.zeros((2, H, W), bool)),
                    ("47 x 121", rng.random((3, 47, 121)) < 0.5), *shape_cases):
        f = torch.from_numpy(f).to(dev)
        sentinel = float(f[0].numel())
        x = label_rank_fused_reference(f, RANK_SWEEPS)[0]
        for sw in (1, 4, 8):
            outputs_compare("sweep_chunk", sweep_chunk(x, f, sw, sentinel),
                            sweep_chunk_reference(x, f, sw, sentinel), f"{what}, {sw} sweeps")
    for sw in (1, 4):
        check(not sweep_chunk(k4_in, fg_s, sw, P)[1].any(), "K5 flags a settled frame")
        check(bool(sweep_chunk(k5_in, fg_s, sw, P)[1].all()),
              "K5 does not flag every frame K2 flagged")
    print(f"phase 4 K5 bit-equal to plain (outputs and flags) with 1, 4 and 8 sweeps on the "
          f"label and rank planes of {tuple(fg_s.shape)}, a background below the sentinel, "
          f"all-foreground and empty frames, a frame touching all four edges, 47 x 121, "
          f"1 x 500 and 300 x 1; flag false on the settled frames, true on K2's flagged ones",
          flush=True)
    # K4 on converged labels: the close-pass frames, the snake + speckle pair
    # and the dense batch (converged by K3, which the plain flood would take
    # long to reach; checked a fixpoint), every tile of which has foreground
    dense_conv = converge_frames(label_rank_fused(dense, RANK_SWEEPS)[0], dense,
                                 cfg.ccl_max_iters, P)
    check(not sweep_chunk_reference(dense_conv, dense, 1, P)[1].any(),
          "K3 did not converge the dense batch")
    for what, x in (("the close-pass frames", k4_in[close]),
                    ("the snake + speckle pair", k4_in[~close]),
                    ("the dense batch", dense_conv)):
        x = x.contiguous()
        flags = []
        for sw in (0, 1, RANK_SWEEPS, 32):
            got = rank_seed_sweep(x, sw)
            outputs_compare("rank_seed_sweep", got, rank_seed_sweep_reference(x, sw),
                            f"{what}, {sw} sweeps")
            flags.append(int(got[1].sum()))
        print(f"phase 4 K4 bit-equal to plain (rank map and flag) on {what} "
              f"{tuple(x.shape)} with 0, 1, {RANK_SWEEPS} and 32 sweeps; frames unsettled "
              f"{flags}", flush=True)
    # K3 on the labels after K5's budget and on the rank plane

    def k3_compare(x, f, what, max_iters=cfg.ccl_max_iters):
        """K3 bit-equal to its plain version, which must reach its fixpoint
        (or, for max_iters 0, return the input)."""
        sentinel = float(f[0].numel())
        got = converge_frames(x, f, max_iters, sentinel)
        want = converge_frames_reference(x, f, max_iters, sentinel)
        torch.cuda.synchronize()
        if max_iters:
            check(not sweep_chunk_reference(want, f, 1, sentinel)[1].any(),
                  f"the plain K3 did not reach the fixpoint on {what}")
        else:
            check(torch.equal(want, x), "the plain K3 with max_iters 0 changed its input")
        slow_err["converge_frames"] = max(slow_err["converge_frames"], f32_err(got, want))
        check(torch.equal(got, want), f"converge_frames disagrees with its plain version on {what}")

    k3_compare(k3_in, fg_s, "the label plane")
    # K3 also finishes rank floods: the rank map after K4 and K5's budget
    k3_compare(sweep_chunk_reference(r_in, fg_s, 24, P)[0], fg_s, "the rank plane")
    k3_compare(k3_in, fg_s, "the label plane with max_iters 0", max_iters=0)
    for what, f in shape_cases:
        f = torch.from_numpy(f).to(dev)
        k3_compare(label_rank_fused_reference(f, RANK_SWEEPS)[0], f, what)
    print(f"phase 4 K3 bit-equal to plain on the label and rank planes, with max_iters 0, "
          f"on a frame touching all four edges, and at 1 x 500 and 300 x 1", flush=True)
    # K3-K5 timed apart on the close-pass frames (flagged among the main
    # path's B*T, the frames the main path meets); K3 also on the snake +
    # speckle pair
    x5, x3, x4, fc = (t[close].contiguous() for t in (k5_in, k3_in, k4_in, fg_s))
    n_close = int(close.sum())
    slow_ms["sweep_chunk"] = alternate_ms(
        torch, lambda: sweep_chunk_reference(x5, fc, 4, P), lambda: sweep_chunk(x5, fc, 4, P),
        reps=20, what="K5")
    slow_ms["rank_seed_sweep"] = alternate_ms(
        torch, lambda: rank_seed_sweep_reference(x4, RANK_SWEEPS),
        lambda: rank_seed_sweep(x4, RANK_SWEEPS), reps=20, what="K4")
    slow_ms["converge_frames"] = alternate_ms(
        torch, lambda: converge_frames_reference(x3, fc, cfg.ccl_max_iters, P),
        lambda: converge_frames(x3, fc, cfg.ccl_max_iters, P), reps=20, what="K3")
    xp, fp = k3_in[~close].contiguous(), fg_s[~close].contiguous()
    k3_pair_ms, k3_pair_plain_ms = alternate_ms(
        torch, lambda: converge_frames_reference(xp, fp, cfg.ccl_max_iters, P),
        lambda: converge_frames(xp, fp, cfg.ccl_max_iters, P), reps=3, what="K3 on the pair")
    for name, label in (("sweep_chunk", "K5, 4 sweeps"), ("rank_seed_sweep", "K4"),
                        ("converge_frames", "K3")):
        print(f"phase 4 {label} on the {n_close} close-pass frames: kernel "
              f"{slow_ms[name][0]:.4f} ms, plain {slow_ms[name][1]:.4f} ms, max |diff| "
              f"{slow_err[name]} [{card}]", flush=True)
    print(f"phase 4 K3 on the snake + speckle pair: kernel {k3_pair_ms:.4f} ms, plain "
          f"{k3_pair_plain_ms:.4f} ms; pair / close-pass "
          f"{k3_pair_ms / slow_ms['converge_frames'][0]:.2f} [{card}]", flush=True)
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
                "rank_seed_sweep": rank_seed_sweep,
                "refined_eigh": refined_eigh}
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
    k7_main_path(r6, launches["refined_eigh"], B, "phase 6")

    # 7. K6 on the state of a real cold-start iteration of one batch
    cold = dataclasses.replace(cfg, rpca_warm_basis=False)
    Xs, As, Ys, inv_mu, lmbda = k6_state(torch, gray_dev, cfg)
    print(f"phase 7 K6 input: X {tuple(Xs.shape)} {Xs.dtype}, A/Y {As.dtype}, "
          f"inv_mu {inv_mu.min().item():.4g}..{inv_mu.max().item():.4g}", flush=True)

    def k6_compare(args, what):
        e, m, g = ialm_front(*args)
        e0, m0, g0 = ialm_front_reference(*args)
        torch.cuda.synchronize()
        g_err = f32_err(g, g0)
        g_max = float(g0.abs().max())
        ok = torch.equal(e, e0) and torch.equal(m, m0) and g_err <= G_RTOL * g_max
        check(ok, f"K6 disagrees with its plain version on {what}: E equal "
                  f"{torch.equal(e, e0)}, M equal {torch.equal(m, m0)}, "
                  f"max|dG| {g_err} vs max|G| {g_max}")
        return f32_err(e, e0), f32_err(m, m0), g_err, g_max

    main_args = (Xs, As, Ys, inv_mu, lmbda)
    e_err, m_err, k6_err, g_max = k6_compare(main_args, "the main path's state")
    check(torch.equal(ialm_front(*main_args)[2], ialm_front(*main_args)[2]),
          "K6's G differs between two calls on the same state")
    print(f"phase 7 K6 vs plain at {tuple(Xs.shape)}: E max |diff| {e_err}, M max |diff| "
          f"{m_err}, G max |diff| {k6_err} (max|G| {g_max:.6g}, limit {G_RTOL} max|G|); "
          f"G bit-identical in two calls", flush=True)
    _, m0, g0 = ialm_front_reference(*main_args)
    g64 = m0.double() @ m0.double().transpose(-1, -2)
    print(f"phase 7 G max |diff| from the f64 Gram of the same M: K6 "
          f"{f32_err(ialm_front(*main_args)[2], g64)}, plain {f32_err(g0, g64)}", flush=True)
    f32_args = (Xs.float(), As.float(), Ys.float(), inv_mu, lmbda)
    k6_compare(f32_args, "the f32 state")
    k6_shapes = ((1, 21, 1), (3, 21, 1000), (2, 21, 4099), (1, 21, 93312), (4, 7, 777),
                 (2, 32, 5000), (2, 1, 300))
    for shape in k6_shapes:
        for xd, sd in ((torch.uint8, torch.bfloat16), (torch.float32, torch.float32)):
            Xr = torch.from_numpy(rng.integers(0, 256, size=shape)).to(dev, xd)
            Ar = (torch.from_numpy(rng.standard_normal(shape) * 60)).to(dev, sd)
            Yr = (torch.from_numpy(rng.standard_normal(shape) * 1e-3)).to(dev, sd)
            im = torch.from_numpy(rng.uniform(0.5, 200.0, shape[0])).to(dev, torch.float32)
            k6_compare((Xr, Ar, Yr, im, 0.01), f"{shape} {xd} {sd}")
    print(f"phase 7 K6 vs plain on {2 * len(k6_shapes)} ragged shapes/dtypes: E, M "
          f"bit-equal, G within tolerance", flush=True)
    k6_ms, k6_plain_ms = alternate_ms(
        torch, lambda: ialm_front_reference(*main_args), lambda: ialm_front(*main_args)
    )
    k6_bound = bound(*k6_bytes_ops(Xs, As, Ys))
    print(f"phase 7 K6 time at {tuple(Xs.shape)}: kernel {k6_ms:.4f} ms, plain "
          f"{k6_plain_ms:.4f} ms, bound {k6_bound[0]:.4f} ms ({k6_bound[1]}) [{card}]",
          flush=True)

    # 8. cold-start RPCA on the batch: with K6, with the plain front, and warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_k6, it_k6 = rpca_motion_window_batched(gray_dev, cold)
    torch.cuda.synchronize()
    t_k6 = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_pl, it_pl = rpca_motion_window_batched(
        gray_dev, dataclasses.replace(cold, use_pallas_rpca=False))
    torch.cuda.synchronize()
    t_pl = time.perf_counter() - t0
    it_diff = int((it_k6 - it_pl).abs().max())
    mot_diff = int((m_k6.int() - m_pl.int()).abs().max())
    warm_cold = int((m_k6.reshape(B * T, H, W).int() - motion.int()).abs().max())
    print(f"phase 8 cold RPCA on one batch: K6 iters {it_k6.min().item()}..{it_k6.max().item()} "
          f"in {t_k6 * 1e3:.1f} ms, plain front iters {it_pl.min().item()}..{it_pl.max().item()} "
          f"in {t_pl * 1e3:.1f} ms; iters max |diff| {it_diff}, motion max |diff| {mot_diff}; "
          f"warm iters {iters.min().item()}..{iters.max().item()}, cold vs warm motion "
          f"max |diff| {warm_cold} [{card}]", flush=True)
    check(it_diff <= 1, "cold RPCA: K6 and the plain front differ by more than 1 iteration")
    check(mot_diff <= 2, "cold RPCA: K6 and the plain front differ by more than 2 u8")

    # 9. the cold-start main path at 1080p, with the launch counters read around it
    wrappers["ialm_front"] = ialm_front
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r9 = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                   bench.corners, cold, dev)
    torch.cuda.synchronize()
    secs9 = time.perf_counter() - t0
    cold_launches = {name: w.launches for name, w in wrappers.items()}
    print(f"phase 9 run_video 1080p cold start: {r9.frames_processed} frames in {secs9:.2f} s "
          f"= {r9.frames_processed / secs9:.1f} frames/s (warm {r6.frames_processed / secs:.1f}) "
          f"[{card}], {len(r9.events)} events ({r9.total_predicted} predicted / "
          f"{r9.total_rejected} rejected), IALM iters {min(r9.ialm_iters)}.."
          f"{max(r9.ialm_iters)}, launches {cold_launches}", flush=True)
    check(r9.frames_processed == n_frames, "cold 1080p run processed the wrong frame count")
    check(all(n > 0 for n in cold_launches.values()),
          "a kernel was not launched on the cold-start path")
    check(r9.metrics.counters.get("sync.ialm_eigh", 0) == 0
          and r9.metrics.counters.get("ialm_eigh", 0) == cold_launches["refined_eigh"],
          f"cold 1080p run: a refined eigh left K7 (counters {r9.metrics.counters})")
    check((r9.total_predicted, r9.total_rejected) == (r6.total_predicted, r6.total_rejected),
          "cold 1080p run: predicted/rejected differ from the warm run")

    # 10. the CLI on the card vs run_video on the CPU, cold start
    with tempfile.TemporaryDirectory() as tmp:
        clip = Path(tmp) / "clip.npy"
        np.save(clip, small.frames)
        ui.save_corners_to_file(clip, small.corners)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["--filepaths", str(clip), "--set", "rpca_warm_basis=false"])
        text = out.getvalue()
        print("phase 10 CLI: " + " | ".join(
            ln.strip() for ln in text.replace("\r", "\n").splitlines() if ln.strip()),
            flush=True)
        check(rc == 0, f"CLI exited {rc}")
        check(re.search(r"clip: 2 predicted / 1 rejected swifts", text) is not None,
              "CLI: want 2 predicted / 1 rejected")
        cpu_dir = Path(tmp) / "cpu"
        run_video(open_source(clip), small.corners, cold, torch.device("cpu"),
                  export_dir=cpu_dir, tracker_impl="device")
        names = sorted(p.name for p in cpu_dir.glob("*.csv"))
        got = sorted(p.name for p in (Path(tmp) / "clip").glob("*.csv"))
        check(len(names) == 6 and got == names, f"CLI CSVs {got} vs CPU {names}")
        for n in names:
            check((cpu_dir / n).read_bytes() == (Path(tmp) / "clip" / n).read_bytes(),
                  f"CLI CSV {n} differs from the CPU run's")
        print(f"phase 10 CLI on the card (device tracker): six CSVs byte-equal to "
              f"run_video with the device tracker on the CPU ({', '.join(names)})", flush=True)

    # 11. T1, the device tracker's scan, vs its plain version; then the main
    # path with the device tracker
    K = cfg.max_tracks
    crop_region = crop_region_from_corners(bench.corners, cfg)
    roi = generate_roi_mask(bench.frames[0], roi_crop_region_from_corners(bench.corners, cfg),
                            crop_region, cfg, device=dev)
    table, _ = localize_windows_gray(gray_dev, cfg)
    cy, cx, kvalid, _ = td.compact_tables(table, K)
    close_in = (cy.reshape(B * T, K), cx.reshape(B * T, K), kvalid.reshape(B * T, K),
                torch.arange(B * T, dtype=torch.int32, device=dev),
                torch.ones(B * T, dtype=torch.bool, device=dev))
    streams = [("the close-pass batch", roi, close_in)]
    n_over = 0
    for what, T_s, most in (("a dense stream", B * T, 30), ("a sparse stream", B * T, 4)):
        ft = fuzz_tables(np, torch, rng, T_s, H, W, most, dev)
        fcy, fcx, fval, fover = td.compact_tables(ft, K)
        n_over += int(fover.sum())
        streams.append((what, roi, (fcy, fcx, fval, torch.arange(T_s, dtype=torch.int32,
                                                                   device=dev),
                                    torch.arange(T_s, device=dev) < T_s - 2 * T)))
    # every third frame empty after two full ones, all inside the ROI: more
    # events than the buffer's 4 T slots
    T_c = 60
    cval = torch.from_numpy(np.arange(T_c) % 3 != 2)[:, None].repeat(1, K).to(dev)
    ccy = torch.from_numpy(rng.uniform(0, H, (1, K)).astype(np.float32)).repeat(T_c, 1).to(dev)
    ccx = torch.from_numpy(rng.uniform(0, W, (1, K)).astype(np.float32)).repeat(T_c, 1).to(dev)
    streams.append(("an event-overflow stream", torch.full_like(roi, 255),
                    (ccy + 0.5 * torch.arange(T_c, device=dev)[:, None], ccx, cval,
                     torch.arange(T_c, dtype=torch.int32, device=dev),
                     torch.ones(T_c, dtype=torch.bool, device=dev))))
    # wider K (4 and 3 columns a lane, 66 not a multiple of 32) and long
    # empty stretches, one at the batch edge
    for what, T_s, most, K_s in (("a K = 64 dense stream", 4 * T, 60, 64),
                                 ("a K = 33 stream", 4 * T, 40, 33)):
        ft = fuzz_tables(np, torch, rng, T_s, H, W, most, dev)
        fcy, fcx, fval, _ = td.compact_tables(ft, K_s)
        streams.append((what, roi, (fcy, fcx, fval, torch.arange(T_s, dtype=torch.int32,
                                                                   device=dev),
                                    torch.arange(T_s, device=dev) < T_s - T)))
    empty_in = []
    for _ in range(2):
        fcy, fcx, fval, _ = td.compact_tables(
            empty_stretch_tables(np, torch, rng, B * T, H, W, dev), K)
        empty_in.append((fcy, fcx, fval, torch.arange(B * T, dtype=torch.int32, device=dev),
                         torch.ones(B * T, dtype=torch.bool, device=dev)))
    streams.append(("a long-empty-stretch stream", roi, empty_in[0]))
    check(n_over > 0, "no fuzz frame overflows compact_tables")

    def t1_check(state, r, inputs, c, what):
        """T1 (and T1a's records) vs the plain versions: (state, events)."""
        args = (state, r, *(x.contiguous() for x in inputs[:3]), *inputs[3:4], c, inputs[4])
        pro1, pro0 = td.track_prologue(*args).to_numpy(), td.track_prologue_reference(*args)
        for name, a in pro0.to_numpy().items():
            check(np.array_equal(a, pro1[name]),
                  f"T1a's {name} differs from track_prologue_reference on {what}")
        s1, e1 = td.track_window(*args)
        s0, e0 = td.track_window_reference(*args)
        torch.cuda.synchronize()
        for name, a in s0.to_numpy().items():
            check(np.array_equal(a, s1.to_numpy()[name]),
                  f"T1 state.{name} differs from its plain version on {what}")
        for name, a in e0.to_numpy().items():
            check(np.array_equal(a, e1.to_numpy()[name]),
                  f"T1 events.{name} differ from its plain version on {what}")
        return s1, e1

    t1_overflowed = False
    carried = {}
    for what, r, inputs in streams:
        vals, act = inputs[2], inputs[4]
        live = vals.sum(1)
        for n_enum in (0, 4, 6):
            c = dataclasses.replace(cfg, track_enum_lap=n_enum)
            s1, e1 = t1_check(td.empty_state(vals.shape[1], dev), r, inputs, c,
                              f"{what}, enum {n_enum}")
            t1_overflowed |= bool(e1.overflow)
            carried[what] = s1
        print(f"phase 11 T1 and T1a bit-equal to plain on {what} ({vals.shape[0]} frames, K = "
              f"{vals.shape[1]}: {int((live == 0).sum())} empty, "
              f"{int(((live > 0) & (live <= 4)).sum())} with 1-4 slots, {int((live > 4).sum())} "
              f"with 5 or more (most {int(live.max())}), {int((~act).sum())} inactive) at "
              f"track_enum_lap 0, 4, 6: {int(e1.count)} events, overflow {bool(e1.overflow)}",
              flush=True)
    check(t1_overflowed, "no stream overflowed the event buffer")
    # states carried into a second launch: the dense stream's live tracks
    # into the long empty stretches, and those (ending empty) into more
    for first, second in (("a dense stream", empty_in[0]),
                          ("a long-empty-stretch stream", empty_in[1])):
        for n_enum in (0, 4, 6):
            t1_check(carried[first], roi, second,
                     dataclasses.replace(cfg, track_enum_lap=n_enum),
                     f"a second launch after {first}, enum {n_enum}")
    print(f"phase 11 T1 bit-equal to plain with the state of the dense and of the "
          f"long-empty-stretch stream carried into a second launch of long empty stretches "
          f"(live tracks in: {int(carried['a dense stream'].valid.sum())})", flush=True)
    print(f"phase 11 fuzz frames over compact_tables' {K} slots: {n_over}", flush=True)
    lat = t1_latencies(torch, build, dev)
    print(f"phase 11 T1 latencies, one warp, ns per dependent step: argmin (two "
          f"__reduce_min_sync) {lat['argmin']:.3f}, xor-butterfly {lat['butterfly']:.3f}, "
          f"shared load + ballot {lat['frame']:.3f} [{card}]", flush=True)

    def t1_counts(args):
        stats = torch.zeros(len(td.STAT_NAMES), dtype=torch.int64, device=dev)
        td.scan_cuda(*args, stats=stats)
        return dict(zip(td.STAT_NAMES, stats.tolist()))

    _, (ycs, xcs, vals, fns, act) = streams[0][1:]
    t1_args = (td.empty_state(K, dev), roi, ycs.contiguous(), xcs.contiguous(),
               vals.contiguous(), fns, cfg, act)
    t1_ms, t1_plain_ms = alternate_ms(torch, lambda: td.track_window_reference(*t1_args),
                                      lambda: td.track_window(*t1_args), reps=2, what="T1")
    _, t1_events = td.track_window(*t1_args)
    t1_bound = track_bound(ycs, vals, int(t1_events.count), len(td._pattern_table(4)))
    t1_stats = t1_counts(t1_args)
    t1_latency = t1_latency_bound(t1_stats, lat)
    # the host tracker on the same batch: its table read back, centroids, steps
    roi_np = roi.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table_h = table.map(lambda a: a.cpu()).map(torch.Tensor.numpy)
    t_read = time.perf_counter()
    host = SegmentTracker(roi_np, cfg)
    for i in range(B * T):
        host.step(frame_centroids(table_h, i // T, i % T), i, i)
    t_host = time.perf_counter()
    host_ms, host_steps_ms = (t_host - t0) * 1e3, (t_host - t_read) * 1e3
    ev_dev = sorted(zip(*(t1_events.to_numpy()[k][: int(t1_events.count)] for k in (
        "last_fn", "first_cy", "first_cx", "last_cy", "last_cx"))))
    ev_host = sorted((e.frame_number, *e.first_centroid, *e.last_centroid) for e in host.events)
    check(len(ev_dev) == len(ev_host) > 0 and all(
        d[0] == h[0] and np.allclose(d[1:], h[1:], atol=1e-3) for d, h in zip(ev_dev, ev_host)),
        "T1's events on the close-pass batch differ from the host tracker's")
    for what, r, (ycs, xcs, vals, fns, act) in streams[1:]:
        a = (td.empty_state(vals.shape[1], dev), r, ycs.contiguous(), xcs.contiguous(),
             vals.contiguous(), fns, cfg, act)
        n = t1_counts(a)
        print(f"phase 11 T1 time on {what}: {time_ms(torch, lambda: td.track_window(*a), 10, 'T1'):.4f} "
              f"ms, latency bound {t1_latency_bound(n, lat):.4f} ms ({n['work frames']} frames with "
              f"work, {n['Dijkstra steps']} Dijkstra steps in {n['JV rows']} JV rows, "
              f"{n['enumeration frames']} enumeration argmins) [{card}]", flush=True)
    print(f"phase 11 T1 on the close-pass batch ({B * T} frames, {len(ev_dev)} events as the "
          f"host tracker's): T1a + T1b {t1_ms:.4f} ms, plain {t1_plain_ms:.4f} ms, host "
          f"SegmentTracker {host_ms:.4f} ms ({host_steps_ms:.4f} ms of steps after "
          f"{host_ms - host_steps_ms:.4f} ms of table read-back), latency bound "
          f"{t1_latency:.4f} ms ({t1_stats['work frames']} frames with work x "
          f"{lat['frame']:.3f} ns + {t1_stats['Dijkstra steps'] + t1_stats['enumeration frames']} "
          f"argmins x {min(lat['argmin'], lat['butterfly']):.3f} ns); byte bound "
          f"{t1_bound[0]:.6f} ms [{card}]", flush=True)

    wrappers["track_window"] = td.track_window
    dev_names = ("fused_motion_filter", "label_rank_fused", "refined_eigh", "track_window")
    for name in dev_names:
        wrappers[name].launches = 0
    td.track_window.kernels = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r11 = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                    bench.corners, cfg, dev, tracker_impl="device")
    torch.cuda.synchronize()
    secs11 = time.perf_counter() - t0
    dev_launches = {name: wrappers[name].launches for name in dev_names}
    t1_kernels = td.track_window.kernels
    print(f"phase 11 run_video 1080p, device tracker: {r11.frames_processed} frames in "
          f"{secs11:.2f} s = {r11.frames_processed / secs11:.1f} frames/s (host tracker, phase "
          f"6: {r6.frames_processed / secs:.1f}) [{card}], {len(r11.events)} events "
          f"({r11.total_predicted} predicted / {r11.total_rejected} rejected), "
          f"{r11.metrics.batches} batches, launches {dev_launches}, T1 kernels {t1_kernels}",
          flush=True)
    check(r11.frames_processed == n_frames, "device-tracker run processed the wrong frame count")
    check(dev_launches["track_window"] == r11.metrics.batches > 0,
          "T1 was not launched once per batch")
    check(t1_kernels == 2 * dev_launches["track_window"],
          "T1's launcher did not launch T1a and T1b on every call")
    check(dev_launches["fused_motion_filter"] > 0 and dev_launches["label_rank_fused"] > 0,
          "K1 or K2 was not launched on the device-tracker run")
    k7_main_path(r11, dev_launches["refined_eigh"], B, "phase 11")
    check((r11.total_predicted, r11.total_rejected) == (r6.total_predicted, r6.total_rejected),
          "device-tracker run: predicted/rejected differ from the host-tracker run")

    def key(e):
        return (e.frame_number, *e.first_centroid, *e.last_centroid)

    d_ev, h_ev = sorted(map(key, r11.events)), sorted(map(key, r6.events))
    check(len(d_ev) == len(h_ev) and all(
        d[0] == h[0] and np.allclose(d[1:], h[1:], atol=1e-3) for d, h in zip(d_ev, h_ev)),
        "device-tracker events differ from the host tracker's")
    print(f"phase 11 device-tracker events equal phase 6's: {len(d_ev)} events, frame numbers "
          f"equal, centroids max |diff| "
          f"{max(float(np.abs(np.subtract(d[1:], h[1:])).max()) for d, h in zip(d_ev, h_ev)):.3g}",
          flush=True)

    phase12(np, torch, dev, cfg, card, bench, gray_dev, idx, small, r11, secs11, wrappers,
            n_frames)
    # half the clip: the script stays within 1.5 times its time before phase 13
    for n, phase, args in (
            (13, phase13, (np, torch, dev, cfg, card, bench, n_frames // 2, wrappers, r11,
                           secs11)),
            (14, phase14, (np, torch, dev, cfg, card, bench, small, wrappers, n_frames, r11,
                           secs11)),
            (15, phase15, (np, torch, dev, cfg, card, bench, small, gray_dev, n_frames, r9,
                           r11)),
            (16, phase16, (np, torch, dev, cfg, card, bench, gray, gray_dev, small, wrappers,
                           n_frames, r6, r11)),
            (17, phase17, (dev, cfg, card)),
            (18, phase18, (np, torch, dev, cfg, card))):
        t0 = time.perf_counter()
        phase(*args)
        print(f"phase {n} took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    k7 = phase19(np, torch, dev, cfg, card, gray_dev)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    k8 = phase20(np, torch, dev, cfg, card, bench, ((x1, y1), (x2, y2)))
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)

    # every kernel's bound at the inputs timed above
    hw = H * W
    bounds = {
        "fused_motion_filter": k1_bound,
        "label_rank_fused": bound(fg_main.numel() * 9 + fg_main.shape[0],
                                  fg_main.numel() * (25 * 4 + 2)),
        "sweep_chunk": bound(n_close * (hw * 9 + 1), n_close * hw * 4 * 8),
        "converge_frames": bound(n_close * hw * 9, n_close * hw * 12),
        "rank_seed_sweep": bound(n_close * (hw * 8 + 1), n_close * hw * (12 * 4 + 2)),
        "ialm_front": k6_bound,
        "track_window": t1_bound,
        "refined_eigh": (k7["latency_bound_ms"], "latency"),
        "ialm_trip": (k8["bytes_bound_ms"], "bytes"),
    }
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
    kernels.append({
        "name": "ialm_front", "route": "cuda",
        "source": "swiftwatcher_tpu_torch/csrc/ialm_front.cu",
        "replaces": "swiftwatcher_tpu/ops/pallas/ialm_front.py:87",
        "launches": cold_launches["ialm_front"], "max_abs_err": k6_err,
        "ms": k6_ms, "plain_ms": k6_plain_ms})
    kernels.append({
        "name": "track_window", "route": "cuda",
        "source": "swiftwatcher_tpu_torch/csrc/track_scan.cu",
        "replaces": "swiftwatcher_tpu/pipeline/tracking_jax.py:410",
        "launches": dev_launches["track_window"], "max_abs_err": 0,  # bit-equal, checked
        "ms": t1_ms, "plain_ms": t1_plain_ms,
        "kernels_per_launch": t1_kernels / dev_launches["track_window"],
        "latency_bound_ms": t1_latency})
    kernels.append({**k7, "launches": dev_launches["refined_eigh"]})
    kernels.append(k8)
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def conv_flops(torch, sq, params, x) -> int:
    """Operations of the convolutions of one forward of x: 2 per
    multiply-add, counted from the shapes each convolution sees."""
    conv = sq.F.conv2d
    total = [0]

    def counting(inp, w, *a, **k):
        out = conv(inp, w, *a, **k)
        total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    sq.F.conv2d = counting
    try:
        sq.forward(params, x[:1])
    finally:
        sq.F.conv2d = conv
    return total[0] * x.shape[0]


# classifier.1.bias[1] of two weight sets that reject part of a scene's
# segments with no logit within 1e-3 of its rival: "split" about half (no
# event is left), "partial" fewer (the events move)
# (tests/test_torch_classify_runner.py)
WEIGHT_SETS = {"split": -200.0, "partial": -150.0}


class RssPeak:
    """The peak resident set of this process while the block runs, sampled
    from /proc every 20 ms, in MiB."""

    def __enter__(self):
        self.peak = 0.0
        self._stop = threading.Event()

        def sample():
            while True:
                with open("/proc/self/status") as fh:
                    for line in fh:
                        if line.startswith("VmRSS:"):
                            self.peak = max(self.peak, int(line.split()[1]) / 1024)
                if self._stop.wait(0.02):
                    return

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def phase12(np, torch, dev, cfg, card, bench, gray_dev, idx, small, r11, secs11, wrappers,
            n_frames) -> None:
    """--classify and --export on the card: the preprocess and the network
    against the CPU, run_video with the filter on three paths, the CLI."""
    import warnings

    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.__main__ import main as cli_main
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource
    from swiftwatcher_tpu_torch.models import squeezenet as sq
    from swiftwatcher_tpu_torch.models.classifier import DEFAULT_WEIGHTS, SqueezeNetSegmentFilter
    from swiftwatcher_tpu_torch.models.preprocess import (
        pack_canvases,
        preprocess_batch,
        resize_coeffs,
    )
    from swiftwatcher_tpu_torch.pipeline import runner as runner_mod
    from swiftwatcher_tpu_torch.pipeline.runner import run_video
    from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

    cpu = torch.device("cpu")
    B, T = cfg.batch_windows, cfg.window_size
    out = cfg.cnn_resize_to
    rng = np.random.default_rng(12)

    # 12.1 the PIL-exact preprocess, card vs CPU, at the 100 sizes of the tests
    sizes = [(h, w) for h in (1, 3, 5, 13, 24, 25, 26, 33, 47, 64)
             for w in (1, 3, 5, 13, 24, 25, 26, 33, 47, 64)]
    canv, hs, ws = pack_canvases([rng.integers(0, 256, (h, w, 3), np.uint8)
                                  for h, w in sizes], 64)
    args = [torch.from_numpy(a) for a in (canv, resize_coeffs(ws, 64, out),
                                          resize_coeffs(hs, 64, out))]
    pre_card = preprocess_batch(*(a.to(dev) for a in args), cfg).cpu()
    check(torch.equal(pre_card, preprocess_batch(*args, cfg)),
          "preprocess_batch on the card differs from the CPU")
    print(f"phase 12 preprocess_batch card == CPU, bit-equal, at {len(sizes)} sizes "
          f"(1..64 x 1..64 in a 64 canvas)", flush=True)

    # 12.2 the network on the close-pass batch's real crops and on seeded
    # canvases, card vs CPU; TF32 left on by a caller is pinned off first
    filt = SqueezeNetSegmentFilter.from_default_weights(cfg, dev)
    filt_cpu = SqueezeNetSegmentFilter(filt.params, cfg, cpu)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    seen_tf32 = []
    forward = sq.forward

    def watched(params, x):
        seen_tf32.append(torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        return forward(params, x)

    sq.forward = watched
    try:
        table, _ = localize_windows_gray(gray_dev, cfg, with_bbox=True)
        host = table.map(lambda a: a.cpu()).map(torch.Tensor.numpy)
        crop_region = crop_region_from_corners(bench.corners, cfg)
        crops = []
        for b in range(B):
            for t in range(T):
                images, _ = filt._frame_images(host, (b, t), bench.frames[idx[b * T + t]],
                                               crop_region)
                crops += [im for im in images if im is not None]
        keep_card = filt.classify_images(crops)
    finally:
        sq.forward = forward
    check(seen_tf32 and not any(seen_tf32), "TF32 was on at the network's forward")
    check(np.array_equal(keep_card, filt_cpu.classify_images(crops)),
          "keep-masks of the close-pass crops differ between card and CPU")
    seeded = [rng.integers(0, 256, (int(h), int(w), 3), np.uint8)
              for h, w in rng.integers(1, 65, (64, 2))]
    sets = {}
    for what, images in (("the close-pass batch's crops", crops), ("seeded canvases", seeded)):
        n, mx = len(images), filt._canvas_bucket(images)
        P = filt._padded_n(n)
        canv, hs, ws = pack_canvases(images + [np.zeros((1, 1, 3), np.uint8)] * (P - n), mx)
        x = preprocess_batch(torch.from_numpy(canv), torch.from_numpy(resize_coeffs(ws, mx, out)),
                             torch.from_numpy(resize_coeffs(hs, mx, out)), cfg)
        x_dev = x.to(dev)
        l_card = sq.forward(filt.params, x_dev).cpu().numpy()[:n]
        l_cpu = sq.forward(filt_cpu.params, x).numpy()[:n]
        margin = float(np.abs(l_cpu[:, 1] - l_cpu[:, 0]).min())
        err = float(np.abs(l_card - l_cpu).max())
        check(np.array_equal(l_card.argmax(1), l_cpu.argmax(1)),
              f"argmaxes differ between card and CPU on {what}")
        print(f"phase 12 SqueezeNet card vs CPU on {what} ({n} crops, {P} rows, canvas {mx}): "
              f"max |logit diff| {err:.3g}, smallest margin {margin:.4g}, argmaxes equal, "
              f"{int((l_cpu.argmax(1) == 1).sum())} kept", flush=True)
        sets[what] = (canv, hs, ws, mx, x_dev)
    canv, hs, ws, mx, x_dev = sets["the close-pass batch's crops"]
    canv_d, hs_d, ws_d = (torch.from_numpy(a).to(dev) for a in (canv, hs, ws))
    coeff = filt._coeff_table(mx)
    # three forwards: over ten, the host's queueing fell behind the device
    cnn_ms = time_ms(torch, lambda: sq.forward(filt.params, x_dev), 3, "the network")
    pre_ms = time_ms(torch, lambda: preprocess_batch(canv_d, coeff[ws_d - 1], coeff[hs_d - 1],
                                                     cfg), 10, "the preprocess")
    flops = conv_flops(torch, sq, filt.params, x_dev)
    cnn_bound, _ = bound(sum(p.numel() * 4 for p in filt.params.values()) + x_dev.numel() * 4,
                         flops)
    print(f"phase 12 on the close-pass batch's {x_dev.shape[0]} rows: SqueezeNet forward "
          f"{cnn_ms:.4f} ms ({flops / 1e9:.1f} GFLOP of convolutions: "
          f"{flops / cnn_ms / 1e9:.1f} TFLOP/s; bound {cnn_bound:.4f} ms at the f32 rate), "
          f"preprocess {pre_ms:.4f} ms (canvas {mx}) [{card}]", flush=True)

    def ev(r):
        return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]

    # 12.3 weight sets that reject part of the small scene's segments, card
    # vs CPU, three paths
    paths = {"host": ("host", True), "fused": ("device", True), "unfused": ("device", False)}
    for weights, bias in WEIGHT_SETS.items():
        with np.load(DEFAULT_WEIGHTS) as data:
            params = {k: data[k].copy() for k in data.files}
        params["classifier.1.bias"][1] = bias
        params = sq.params_from_jax(params)
        res = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            f = SqueezeNetSegmentFilter(params, cfg, d)
            for name, (impl, fused) in paths.items():
                res[where, name] = run_video(
                    ArraySource(small.frames, fps=small.fps), small.corners,
                    dataclasses.replace(cfg, classify_fused=fused), d, tracker_impl=impl,
                    segment_filter=f)
        for name in paths:
            a, b = res["card", name], res["cpu", name]
            check(ev(a) == ev(b) and (a.total_predicted, a.total_rejected) == (
                b.total_predicted, b.total_rejected), f"{weights} weights, {name}: card != CPU")
            check(a.metrics.segments_total == b.metrics.segments_total == res[
                "cpu", "host"].metrics.segments_total,
                f"{weights} weights, {name}: segments kept differ")
        r = res["card", "fused"]
        print(f"phase 12 run_video with the {weights} weights (bias {bias}) on the small scene, "
              f"card == CPU on the host, fused and unfused paths: {len(r.events)} events "
              f"({r.total_predicted} predicted / {r.total_rejected} rejected), "
              f"{r.metrics.segments_total} segments kept", flush=True)

    # 12.4 --classify at 1080p on the 1008 close-pass frames: fused, unfused
    # and the host tracker; the fused run is watched for host syncs between
    # its upload and T1
    fused_call = runner_mod.classify_track_fused
    syncs = []

    def no_sync(*a, **k):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fused_call(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                # torch's warning for each synchronizing call it sees (it
                # also warns once that the mode is a prototype)
                syncs.extend(str(x.message) for x in w
                             if "called a synchronizing" in str(x.message))

    k_names = ("fused_motion_filter", "label_rank_fused", "sweep_chunk", "converge_frames",
               "rank_seed_sweep", "track_window")
    big = {}
    for name, (impl, fused) in paths.items():
        for k in k_names:
            wrappers[k].launches = 0
        runner_mod.classify_track_fused = no_sync if name == "fused" else fused_call
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        filt.upload_bytes = 0
        try:
            with RssPeak() as rss:
                t0 = time.perf_counter()
                r = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                              bench.corners, dataclasses.replace(cfg, classify_fused=fused), dev,
                              tracker_impl=impl, segment_filter=filt)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
        finally:
            runner_mod.classify_track_fused = fused_call
        launches = {k: wrappers[k].launches for k in k_names}
        big[name] = r
        stages = {k: round(v, 4) for k, v in r.metrics.stage_seconds.items()
                  if k.startswith("classify")}
        print(f"phase 12 run_video 1080p --classify, {name}: {r.frames_processed} frames in "
              f"{s:.2f} s = {r.frames_processed / s:.1f} frames/s (without classify, phase 11: "
              f"{r11.frames_processed / secs11:.1f}) [{card}], {len(r.events)} events "
              f"({r.total_predicted} predicted / {r.total_rejected} rejected), "
              f"{r.metrics.segments_total} segments kept, classify stages {stages}, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, peak host RSS "
              f"{rss.peak:.1f} MiB, classifier upload {filt.upload_bytes / r.metrics.batches:.0f} "
              f"B a batch, launches {launches}", flush=True)
        check(r.frames_processed == n_frames, f"--classify {name}: wrong frame count")
        check(filt.upload_bytes > 0, f"--classify {name}: the classifier uploaded nothing")
        check(all(launches[k] > 0 for k in k_names[:5]),
              f"--classify {name}: a kernel of K1-K5 was not launched")
        if impl == "device":
            check(launches["track_window"] == r.metrics.batches,
                  f"--classify {name}: T1 was not launched once per batch")
    check(not syncs, f"the fused path synchronised the host: {syncs[:3]}")

    # host memory with frames that a decoder would allocate: the clip's
    # frames are views of one array above, so keep_frames cost them nothing
    class Decoded(LoopingArraySource):
        def read_frame(self, frame_number, increment=True):
            frame = super().read_frame(frame_number, increment)
            return None if frame is None else frame.copy()

    for what, kw in (("without classify", {}), ("--classify, fused", {"segment_filter": filt})):
        with RssPeak() as rss:
            t0 = time.perf_counter()
            r = run_video(Decoded(bench.frames, total=n_frames, fps=bench.fps), bench.corners,
                          cfg, dev, tracker_impl="device", **kw)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        print(f"phase 12 1080p with frames copied on read (a decoding source), device "
              f"tracker, {what}: peak host RSS {rss.peak:.1f} MiB, {r.frames_processed / s:.1f} "
              f"frames/s, {len(r.events)} events [{card}]", flush=True)

    def key(e):
        return (e.frame_number, *e.first_centroid, *e.last_centroid)

    want = sorted(map(key, r11.events))
    check(ev(big["unfused"]) == ev(big["fused"]), "--classify: unfused events != fused events")
    for name, r in big.items():
        got = sorted(map(key, r.events))
        check(len(got) == len(want) and all(
            g[0] == h[0] and np.allclose(g[1:], h[1:], atol=1e-3) for g, h in zip(got, want)),
            f"--classify {name}: events differ from phase 11's")
        check(r.metrics.segments_total == big["fused"].metrics.segments_total,
              f"--classify {name}: segments kept differ from the fused run's")
    print(f"phase 12 --classify events equal across the three paths and to phase 11's "
          f"({len(want)} events; {big['fused'].metrics.segments_total} segments kept), no host "
          f"sync in the fused path", flush=True)

    # 12.5 the CLI with --classify --export on the card (its default, the
    # device tracker, which must launch T1) vs the host tracker on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for where, d, tracker in (("card", dev, "device"), ("cpu", cpu, "host")):
            clip = Path(tmp) / where / "clip.npy"
            clip.parent.mkdir()
            np.save(clip, small.frames)
            ui.save_corners_to_file(clip, small.corners)
            wrappers["track_window"].launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["--filepaths", str(clip), "--classify", "--export",
                               "--device", d.type, "--tracker", tracker])
            check(rc == 0, f"CLI --classify --export on {where} exited {rc}")
            if where == "card":
                t1_export = wrappers["track_window"].launches
                check(t1_export > 0, "CLI --classify --export: T1 was not launched")
            dirs[where] = clip.parent / "clip"
        names = sorted(p.name for p in dirs["cpu"].glob("*.csv"))
        check(len(names) == 6 and names == sorted(p.name for p in dirs["card"].glob("*.csv")),
              "CLI --classify --export: CSV sets differ")
        for n in names:
            check((dirs["cpu"] / n).read_bytes() == (dirs["card"] / n).read_bytes(),
                  f"CLI --classify --export: {n} differs between card and CPU")
        pngs = {w: sorted(p.relative_to(d) for p in (d / "segments").rglob("*.png"))
                for w, d in dirs.items()}
        check(pngs["cpu"] and pngs["cpu"] == pngs["card"], "CLI --export: PNG sets differ")
        for p in pngs["cpu"]:
            check((dirs["cpu"] / p).read_bytes() == (dirs["card"] / p).read_bytes(),
                  f"CLI --export: {p} differs between card and CPU")
        print(f"phase 12 CLI --classify --export on the card, device tracker ({t1_export} T1 "
              f"launches): six CSVs and {len(pngs['cpu'])} PNGs byte-equal to the host "
              f"tracker's on the CPU", flush=True)


# The decode backends of each container, in the order `auto` tries them.
BACKENDS = {"avi": ("native", "parallel", "cv2"), "mp4": ("parallel", "av", "cv2"),
            "h264": ("parallel", "av", "cv2")}


class CliRuns:
    """The CLI with its decode backend forced (`open_source` patched to open
    containers with `backend`; "auto" leaves the CLI's own), recording what
    each run_video call saw: the source's backend and decode workers, the
    run's wall time and its result."""

    def __init__(self, torch, main_mod, video_source, backend: str):
        self.torch, self.main_mod, self.runs = torch, main_mod, []
        self.video_source, self.backend = video_source, backend

    def __enter__(self):
        self.real = self.main_mod.run_video, self.main_mod.open_source
        real_run, real_open = self.real

        def recorded(source, *a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real_run(source, *a, **k)
            self.torch.cuda.synchronize()
            self.runs.append((source.backend, source.decode_workers,
                              time.perf_counter() - t0, r))
            return r

        def opened(path, start=0, end=0):
            return self.video_source(path, end, backend=self.backend)

        self.main_mod.run_video = recorded
        if self.backend != "auto":
            self.main_mod.open_source = opened
        return self

    def __exit__(self, *exc):
        self.main_mod.run_video, self.main_mod.open_source = self.real


def write_containers(np, bench, n_frames, tmp: Path, ui, native_av):
    """The close-pass clip as an MJPG AVI and an mp4v MP4 (cv2), and as an
    H.264 MP4 (libx264 through write_test_video) where it is built, each
    with its attributes.json: {kind: path}; the seconds each took."""
    from swiftwatcher_tpu_torch.io.synthetic import write_container

    idx = np.arange(n_frames) % len(bench.frames)
    out, secs = {}, {}
    for kind, name, fourcc in (("avi", "clip_mjpg.avi", "MJPG"), ("mp4", "clip_mp4v.mp4", "mp4v")):
        t0 = time.perf_counter()
        path = tmp / name
        check(write_container(path, (bench.frames[i] for i in idx), bench.fps, fourcc),
              f"cv2 cannot write {fourcc}")
        out[kind], secs[kind] = path, time.perf_counter() - t0
    if native_av.is_available():
        t0 = time.perf_counter()
        path = tmp / "clip_h264.mp4"
        if native_av.write_test_video(path, bench.frames[idx], bench.fps, "libx264"):
            out["h264"], secs["h264"] = path, time.perf_counter() - t0
    for path in out.values():
        ui.save_corners_to_file(path, bench.corners)
    return out, secs


def phase13(np, torch, dev, cfg, card, bench, n_frames, wrappers, r11, secs11) -> None:
    """Real containers at 1080p: the close-pass clip written as an MJPG AVI
    and as MP4s, the CLI (device tracker) on each through every decode
    backend that engages, the six CSVs byte-equal across one file's
    backends, and a checkpoint resume on the parallel MP4."""
    import swiftwatcher_tpu_torch.__main__ as main_mod
    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.io import native, native_av
    from swiftwatcher_tpu_torch.io.parallel_decode import probe_seek_accuracy
    from swiftwatcher_tpu_torch.io.source import VideoFileSource
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    libs = {"native": native.is_available(), "av": native_av.is_available()}
    print(f"phase 13 host decoders built here: framepump (native, libjpeg) {libs['native']}, "
          f"avpump (av, libav) {libs['av']}; decode workers {os.cpu_count()} (cores)", flush=True)
    k_names = ("fused_motion_filter", "label_rank_fused", "track_window")
    with tempfile.TemporaryDirectory() as tmp:
        files, wsecs = write_containers(np, bench, n_frames, Path(tmp), ui, native_av)
        print(f"phase 13 wrote {n_frames} frames at {bench.frames.shape[2]}x"
              f"{bench.frames.shape[1]}: " + ", ".join(
            f"{k} {files[k].name} {files[k].stat().st_size / 2**20:.1f} MiB in {wsecs[k]:.1f} s"
            for k in files) + ("" if "h264" in files else
                               "; no H.264 MP4 (write_test_video has no libx264 here)"),
            flush=True)
        full_parallel = None
        for kind, path in files.items():
            # where each named backend must engage: native and av wherever
            # their library is built, parallel wherever cv2's seek is exact
            # (the probe VideoFileSource runs); cv2 always.  auto takes the
            # first of them, in BACKENDS' order
            must = {b: m for b, m in {"parallel": probe_seek_accuracy(path, n_frames),
                                      **libs}.items() if b in BACKENDS[kind]}
            want_auto = next((b for b in BACKENDS[kind] if must.get(b)), "cv2")
            csvs = {}
            for backend in ("auto",) + BACKENDS[kind]:
                if backend in csvs:
                    continue                # auto took it already
                if backend in must:
                    # a backend asked for by name raises where it cannot engage
                    try:
                        VideoFileSource(path, backend=backend).close()
                    except ValueError as e:
                        check(not must[backend], f"{kind}: backend {backend} did not engage "
                              f"where it must: {e}")
                        print(f"phase 13 {kind}: backend {backend} not run: {e}", flush=True)
                        continue
                for k in k_names:
                    wrappers[k].launches = 0
                with CliRuns(torch, main_mod, VideoFileSource, backend) as rec, \
                        contextlib.redirect_stdout(io.StringIO()):
                    rc = main_mod.main(["--filepaths", str(path)])
                check(rc == 0, f"CLI on {path.name} ({backend}) exited {rc}")
                got, workers, secs, r = rec.runs[0]
                if backend == "auto":
                    check(got == want_auto, f"{kind}: auto took {got}, not {want_auto} "
                          f"(engageable: {must})")
                else:
                    check(got == backend, f"{kind}: asked for {backend}, got {got}")
                launches = {k: wrappers[k].launches for k in k_names}
                st = r.metrics.stage_seconds
                # the source alone: the frames the prefetch worker reads
                src = VideoFileSource(path, backend=got)
                t0 = time.perf_counter()
                for _ in range(n_frames):
                    src.get_frame()
                decode_s = time.perf_counter() - t0
                src.close()
                print(f"phase 13 CLI {kind} backend {backend}: source.backend {got}, "
                      f"decode_workers {workers}, {r.frames_processed} frames in {secs:.2f} s = "
                      f"{r.frames_processed / secs:.1f} frames/s (phase 11, frames in memory: "
                      f"{r11.frames_processed / secs11:.1f}; the source alone: "
                      f"{n_frames / decode_s:.1f}) [{card}], prefetch_wait "
                      f"{st.get('prefetch_wait', 0):.3f} s, localize {st.get('localize', 0):.3f} "
                      f"s, consume {st.get('consume', 0):.3f} s, {r.total_predicted} predicted / "
                      f"{r.total_rejected} rejected, read_errors {r.metrics.read_errors}, "
                      f"launches {launches}", flush=True)
                check(r.frames_processed == n_frames, f"{kind} {got}: wrong frame count")
                check(launches["track_window"] == r.metrics.batches > 0
                      and launches["fused_motion_filter"] > 0
                      and launches["label_rank_fused"] > 0,
                      f"{kind} {got}: K1, K2 or T1 not launched")
                out_dir = path.parent / path.stem
                csvs[got] = {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.csv"))}
                check(len(csvs[got]) == 6, f"{kind} {got}: want six CSVs")
                if kind == "mp4" and got == "parallel":
                    full_parallel = r
            check("cv2" in csvs and all(b in csvs for b, m in must.items() if m),
                  f"{kind}: ran {sorted(csvs)}, engageable {must}")
            first = next(iter(csvs.values()))
            check(all(c == first for c in csvs.values()),
                  f"{kind}: the CSVs differ between backends {sorted(csvs)}")
            print(f"phase 13 {kind}: six CSVs byte-equal across backends {sorted(csvs)}",
                  flush=True)
        check(full_parallel is not None, "the MP4's parallel backend did not run")

        # resume: cut at half the clip with a checkpoint every batch, then
        # resume over the whole file on the parallel backend
        ck = Path(tmp) / "state.ckpt"
        src = VideoFileSource(files["mp4"], backend="parallel")
        src.end_frame = src.total_frames = n_frames // 2
        run_video(src, bench.corners, cfg, dev, tracker_impl="device",
                  checkpoint_path=ck, checkpoint_interval_batches=1)
        src.close()
        src = VideoFileSource(files["mp4"], backend="parallel")
        resumed = run_video(src, bench.corners, cfg, dev, tracker_impl="device",
                            checkpoint_path=ck)
        src.close()

        def ev(r):
            return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]

        check(ev(resumed) == ev(full_parallel) and resumed.total_predicted
              == full_parallel.total_predicted, "resumed parallel MP4 run differs from the full run")
        print(f"phase 13 checkpoint resume on the parallel MP4 (cut at frame {n_frames // 2}): "
              f"{len(resumed.events)} events, equal to the full run's", flush=True)


def phase14(np, torch, dev, cfg, card, bench, small, wrappers, n_frames, r11, secs11) -> None:
    """The flags: --profile, --parallel-videos 2, stabilize_window card ==
    CPU, --accuracy-pack card == CPU, and the .h5 error without h5py."""
    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.__main__ import main as cli_main
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io.source import LoopingArraySource, open_source
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video, make_video
    from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
    from swiftwatcher_tpu_torch.ops.stabilize import stabilize_window
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    def save_clip(tmp, name, frames, corners):
        """A .npy clip with its attributes.json, for the CLI."""
        clip = Path(tmp) / name
        clip.parent.mkdir(parents=True, exist_ok=True)
        np.save(clip, frames)
        ui.save_corners_to_file(clip, corners)
        return clip

    def csvs(d):
        return {p.name: p.read_bytes() for p in sorted(Path(d).glob("*.csv"))}

    # 14.1 --profile on the small scene; then the profiled 1080p run
    with tempfile.TemporaryDirectory() as tmp:
        clip = save_clip(tmp, "clip.npy", small.frames, small.corners)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["--filepaths", str(clip), "--profile"])
        check(rc == 0, f"CLI --profile exited {rc}")
        prof = clip.parent / "clip" / "profile"
        trace = json.loads((prof / "trace.json").read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        entries = ("swt_fused_motion", "swt_label_rank_fused", "swt_track_scan")
        check(all(n in names for n in entries), f"the trace lacks one of {entries}")
        # the kernels of K1, K2 and T1 (T1a and T1b), where the profiler
        # traced the card (CUPTI) at all
        device_events = [e.get("name", "") for e in trace["traceEvents"]
                         if e.get("cat") == "kernel"]
        kernels = {k: sum(k in n for n in device_events)
                   for k in ("fused_motion_kernel", "label_tiles_kernel",
                             "track_prologue_kernel", "track_chain_kernel")}
        check(not device_events or all(kernels.values()),
              f"the trace has {len(device_events)} kernels but not each of {kernels}")
        manifest = json.loads((clip.parent / "clip" / "run_manifest.json").read_text())
        dss = manifest["device_stage_seconds"]
        check({"localize", "track_scan"} <= set(dss), f"manifest device stages {dss}")
        print(f"phase 14 CLI --profile: trace.json {(prof / 'trace.json').stat().st_size / 2**20:.2f}"
              f" MiB names {', '.join(entries)}; {len(device_events)} CUDA kernels in it, "
              f"launches of ours {kernels}; "
              f"device_stage_seconds {dss}", flush=True)
        wrappers["track_window"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                       bench.corners, cfg, dev, tracker_impl="device",
                       profile_dir=Path(tmp) / "prof1080")
        torch.cuda.synchronize()
        sp = time.perf_counter() - t0
        check([e.frame_number for e in rp.events] == [e.frame_number for e in r11.events],
              "profiled 1080p run: events differ from phase 11's")
        print(f"phase 14 run_video 1080p profiled, device tracker: {rp.frames_processed / sp:.1f} "
              f"frames/s (phase 11 unprofiled: {r11.frames_processed / secs11:.1f}) [{card}], "
              f"device_stage_seconds "
              f"{ {k: round(v, 4) for k, v in rp.metrics.device_stage_seconds.items()} }, "
              f"events equal phase 11's", flush=True)

    # 14.2 --parallel-videos 2, also with --profile, vs two sequential runs,
    # on the card
    second = make_video(seed=1, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1)
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for mode, flags in (("parallel", ["--parallel-videos", "2"]),
                            ("profiled", ["--parallel-videos", "2", "--profile"]),
                            ("sequential", [])):
            clips = [save_clip(tmp, f"{mode}/clip{i}.npy", v.frames, v.corners)
                     for i, v in enumerate((small, second))]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["--filepaths", *map(str, clips), *flags])
            check(rc == 0, f"CLI {mode} exited {rc}")
            out[mode] = ([csvs(c.parent / c.stem) for c in clips], time.perf_counter() - t0)
        check(all(len(c) == 6 for c in out["sequential"][0])
              and out["parallel"][0] == out["profiled"][0] == out["sequential"][0],
              "--parallel-videos 2: CSVs differ from sequential runs")
        # the profiled runs: one traces at a time, each has its device times
        traced = []
        for i in range(2):
            d = Path(tmp) / "profiled" / f"clip{i}"
            dss = json.loads((d / "run_manifest.json").read_text())["device_stage_seconds"]
            check({"localize", "track_scan"} <= set(dss), f"profiled clip{i}: device stages {dss}")
            if (d / "profile" / "trace.json").exists():
                trace = json.loads((d / "profile" / "trace.json").read_text())
                names = {e.get("name", "") for e in trace["traceEvents"]}
                check("swt_track_scan" in names, f"profiled clip{i}: trace lacks T1's launcher")
                traced.append(f"clip{i}")
        check(bool(traced), "--parallel-videos 2 --profile: no run wrote a trace")
        print(f"phase 14 CLI --parallel-videos 2 on two clips: CSVs byte-equal to two sequential "
              f"runs ({out['parallel'][1]:.2f} s vs {out['sequential'][1]:.2f} s) [{card}]; with "
              f"--profile too ({out['profiled'][1]:.2f} s), traces of {traced}, device times of "
              f"both", flush=True)

    # 14.3 stabilize_window on one bench batch shaken by planted shifts, J=3
    # (each frame's crop taken at a planted offset from the chimney crop)
    J = 3
    B, T = cfg.batch_windows, cfg.window_size
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    planted = np.random.default_rng(14).integers(-J, J + 1, size=(B * T, 2))
    idx = np.arange(B * T) % len(bench.frames)
    shaken = np.stack([bgr_to_gray_host(bench.frames[i, y1 + dy : y2 + dy, x1 + dx : x2 + dx])
                       for i, (dy, dx) in zip(idx, planted)]).reshape(B, T, y2 - y1, x2 - x1)
    ref = bgr_to_gray_host(bench.frames[0, y1:y2, x1:x2])
    card_out = stabilize_window(torch.from_numpy(shaken).to(dev), J,
                                torch.from_numpy(ref).to(dev))
    cpu_out = stabilize_window(torch.from_numpy(shaken), J, torch.from_numpy(ref))
    a_err = int((card_out[0].cpu().int() - cpu_out[0].int()).abs().max())
    s_err = int((card_out[1].cpu() - cpu_out[1]).abs().max())
    check(a_err == 0 and s_err == 0, "stabilize_window: card differs from the CPU")
    recovered = int((cpu_out[1].reshape(-1, 2).numpy() == -planted).all(1).sum())
    shaken_dev, ref_dev = torch.from_numpy(shaken).to(dev), torch.from_numpy(ref).to(dev)
    stab_ms = time_ms(torch, lambda: stabilize_window(shaken_dev, J, ref_dev), 3, "stabilize")
    print(f"phase 14 stabilize_window J={J} on {tuple(shaken.shape)}: card == CPU bit for bit "
          f"(frames and shifts); {recovered} of {B * T} planted shifts recovered exactly; "
          f"{stab_ms:.3f} ms on the card [{card}]", flush=True)

    # 14.4 --accuracy-pack on the card == on the CPU, on the accuracy
    # corpus's jitter2 scene (camera shake of +-2 px)
    corpus = tool_module("torch_accuracy_corpus")
    shake = make_hard_video(**corpus.BASE, **corpus.SCENES["jitter2"])
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for where in ("cuda", "cpu"):
            clip = save_clip(tmp, f"{where}/clip.npy", shake.frames, shake.corners)
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc = cli_main(["--filepaths", str(clip), "--accuracy-pack", "--device", where])
            check(rc == 0, f"CLI --accuracy-pack on {where} exited {rc}")
            got[where] = (csvs(clip.parent / "clip"), text.getvalue())
        check(len(got["cpu"][0]) == 6 and got["cuda"][0] == got["cpu"][0],
              "--accuracy-pack: CSVs differ between card and CPU")
        line = [ln for ln in got["cuda"][1].splitlines() if "predicted" in ln]
        print(f"phase 14 CLI --accuracy-pack on the corpus's jitter2 scene (+-2 px): six CSVs "
              f"byte-equal card vs CPU; {line[-1].strip() if line else 'no events'}", flush=True)

    # 14.5 an .h5 without h5py
    if importlib.util.find_spec("h5py") is not None:
        print("phase 14 h5py is installed here: the .h5 error is not exercised", flush=True)
    else:
        try:
            open_source(Path("missing.h5"))
            check(False, "opening an .h5 without h5py did not raise")
        except ImportError as e:
            check("h5py" in str(e) and ".npy" in str(e), f"the .h5 error does not say why: {e}")
            print(f"phase 14 .h5 without h5py: ImportError: {e}", flush=True)



def phase15(np, torch, dev, cfg, card, bench, small, gray_dev, n_frames, r9, r11) -> None:
    """--mesh on the one-card machine: a (1, 1) mesh on NCCL, (1, 2) and
    (2, 1) on gloo with the ranks sharing the card; the dp x tp train step
    and the fine-tune."""
    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.__main__ import main as cli_main
    from swiftwatcher_tpu_torch.io.source import LoopingArraySource
    from swiftwatcher_tpu_torch.models import train
    from swiftwatcher_tpu_torch.models.squeezenet import random_params
    from swiftwatcher_tpu_torch.parallel.mesh import (
        gather_head,
        init_sharded_training,
        make_mesh,
        ping,
        rank_counters,
        sharded_localize_windows_gray,
    )
    from swiftwatcher_tpu_torch.pipeline.runner import run_video
    from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

    cold = dataclasses.replace(cfg, rpca_warm_basis=False)
    table_1, iters_1 = localize_windows_gray(gray_dev, cfg)

    def key(e):
        return (e.frame_number, *e.first_centroid, *e.last_centroid)

    def same_events(r, want):
        a, b = sorted(map(key, r.events)), sorted(map(key, want.events))
        return ((r.total_predicted, r.total_rejected) == (want.total_predicted,
                                                           want.total_rejected)
                and len(a) == len(b) and all(x[0] == y[0] and np.allclose(x[1:], y[1:], atol=1e-3)
                                             for x, y in zip(a, b)))

    def first_batch(mesh):
        t0 = time.perf_counter()
        table, iters = sharded_localize_windows_gray(gray_dev, mesh, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for f in ("valid", "area", "sum_y", "sum_x"):
            check(torch.equal(getattr(table, f), getattr(table_1, f)),
                  f"mesh {mesh}: first-batch table field {f} differs from the unsharded one")
        it = int((iters - iters_1).abs().max())
        check(it <= 1, f"mesh {mesh}: IALM iterations differ by {it}")
        return f"first-batch tables equal the unsharded ones (iters max |diff| {it}, {ms:.1f} ms)"

    def mesh_run(mesh, run_cfg, want, label):
        mesh.run(rank_counters, reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_video(LoopingArraySource(bench.frames, total=n_frames, fps=bench.fps),
                      bench.corners, run_cfg, dev, tracker_impl="device", mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counters = mesh.run(rank_counters)
        check(r.frames_processed == n_frames, f"mesh {label}: wrong frame count")
        check(same_events(r, want), f"mesh {label}: events differ from the unsharded run's")
        need = ("fused_motion_filter", "label_rank_fused") + (
            ("ialm_front",) if not run_cfg.rpca_warm_basis else ())
        for rank, launches in enumerate(counters["launches"]):
            check(all(launches[k] > 0 for k in need),
                  f"mesh {label}: rank {rank} did not launch each of {need}: {launches}")
        per_batch = [s / r.metrics.batches for s in counters["collective_seconds"]]
        print(f"phase 15 run_video 1080p on the {label} mesh ({mesh.backend}): "
              f"{r.frames_processed} frames in {secs:.2f} s = {r.frames_processed / secs:.1f} "
              f"frames/s, collectives {', '.join(f'{s:.4f}' for s in per_batch)} s a batch "
              f"by rank [{card}]; {len(r.events)} events equal the unsharded run's; launches "
              f"by rank {counters['launches']}", flush=True)

    # 15.1 one rank on NCCL: the sharded program with no collective
    with make_mesh((1, 1), device=dev, timeout=600) as mesh:
        check(mesh.backend == "nccl", f"(1, 1) mesh on {mesh.backend}, want nccl")
        print(f"phase 15 (1, 1) mesh on {mesh.backend}: {first_batch(mesh)}", flush=True)
        mesh_run(mesh, cfg, r11, "1x1")

    # 15.2 two ranks sharing the card on gloo: pixels split over 'model',
    # warm and cold; then the dp x tp train step against one process's
    with make_mesh((1, 2), device=dev, timeout=600) as mesh:
        check(mesh.backend == "gloo", f"(1, 2) mesh on {mesh.backend}, want gloo")
        t0 = time.perf_counter()
        for _ in range(5):
            mesh.run(ping)
        trip = (time.perf_counter() - t0) / 5 * 1e3
        print(f"phase 15 (1, 2) mesh on {mesh.backend}: a run's round trip {trip:.2f} ms "
              f"(load average {os.getloadavg()[0]:.2f}, {threading.active_count()} threads "
              f"here); {first_batch(mesh)}", flush=True)
        mesh_run(mesh, cfg, r11, "1x2 warm")
        mesh_run(mesh, cold, r9, "1x2 cold")

        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        params = random_params(rng, device=dev)
        feats = torch.from_numpy(rng.standard_normal((8, 512, 3, 3)).astype(np.float32)).to(dev)
        labels = np.arange(8) % 2
        feats[labels == 1, :64] += 3.0
        _, head = train.split_params(params)
        opt = train.make_optimizer(head, 1e-3)
        _, _, _, step, place = init_sharded_training(mesh, params, lr=1e-3)
        placed = place(head, opt, feats, labels)
        lab = torch.from_numpy(labels).to(dev)
        unsharded = train.make_train_step()
        want = [float(unsharded(head, opt, feats, lab)[2]) for _ in range(5)]
        got = [step(*placed)[2] for _ in range(5)]
        whole = gather_head(placed[0])
        head_err = max(float((whole[k] - head[k].detach().cpu()).abs().max())
                       for k in train.HEAD_KEYS)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"phase 15 sharded_train_step on (1, 2) vs one process on the card, 5 steps: "
              f"losses {['%.6f' % v for v in got]}, rel |diff| {loss_err:.3g}, head max |diff| "
              f"{head_err:.3g}, {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        check(loss_err <= 1e-5 and head_err <= 1e-6,
              "sharded train step differs from the unsharded one")

    # 15.3 two ranks on gloo, windows split over 'data'
    with make_mesh((2, 1), device=dev, timeout=600) as mesh:
        print(f"phase 15 (2, 1) mesh on {mesh.backend}: {first_batch(mesh)}", flush=True)
        mesh_run(mesh, cfg, r11, "2x1")

    # 15.4 the CLI: --mesh 1x1 gives the CSVs of the run without it; --mesh
    # 2x1 asks for more cards than there are
    with tempfile.TemporaryDirectory() as tmp:
        csvs = {}
        for name, flags in (("plain", []), ("mesh", ["--mesh", "1x1"])):
            clip = Path(tmp) / name / "clip.npy"
            clip.parent.mkdir()
            np.save(clip, small.frames)
            ui.save_corners_to_file(clip, small.corners)
            with contextlib.redirect_stdout(io.StringIO()):
                check(cli_main(["--filepaths", str(clip), *flags]) == 0, f"CLI {flags} failed")
            csvs[name] = {p.name: p.read_bytes() for p in sorted((clip.parent / "clip").glob("*.csv"))}
        check(len(csvs["plain"]) == 6 and csvs["mesh"] == csvs["plain"],
              "CLI --mesh 1x1: CSVs differ from the CLI without it")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["--filepaths", str(clip), "--mesh", "2x1"])
        have = torch.cuda.device_count()
        if have < 2:
            check(rc == 2 and f"needs 2 devices; only {have} available" in err.getvalue(),
                  f"CLI --mesh 2x1 on {have} card(s): rc {rc}, {err.getvalue()!r}")
        print(f"phase 15 CLI --mesh 1x1: six CSVs byte-equal to the CLI without it; --mesh 2x1 "
              f"on {have} card(s): exit {rc}, {err.getvalue().strip()!r}", flush=True)

    # 15.5 the fine-tune on the card against the CPU
    rng = np.random.default_rng(4)
    images = rng.standard_normal((6, 224, 224, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0])
    params = {k: v.cpu() for k, v in random_params(np.random.default_rng(5)).items()}
    t0 = time.perf_counter()
    on_card = train.finetune(params, images, labels, steps=3, batch_size=4, seed=7, device=dev)
    secs = time.perf_counter() - t0
    on_cpu = train.finetune(params, images, labels, steps=3, batch_size=4, seed=7,
                            device=torch.device("cpu"))
    errs = {k: float(np.abs(on_card[k] - on_cpu[k]).max()) for k in train.HEAD_KEYS}
    print(f"phase 15 finetune (3 steps of 4 images at 224 x 224) card vs CPU: head max |diff| "
          f"{errs} (tolerance 1e-6), {secs:.2f} s on the card [{card}]", flush=True)
    check(max(errs.values()) <= 1e-6, "finetune on the card differs from the CPU")


# IALM in f64, device solver vs the host_svd oracle: the CPU test's bound
# (tests/test_torch_window_single.py IALM_F64_ATOL)
IALM_F64_ATOL = 1e-6
# An escape cap the close-pass batch fits: its four 64 x 64 block frames,
# repeated five times a batch, overflow the default cap of 65536 (phase 16
# prints the escape counts)
WIDE_ESCAPE_CAP = 262144


def tool_module(name: str):
    """tools/<name>.py of this checkout, as a module (loaded once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod               # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def phase16(np, torch, dev, cfg, card, bench, gray, gray_dev, small, wrappers, n_frames, r6,
            r11) -> None:
    """The last modules: the wire codec (decodes on the card bit-equal at
    the main path's shape, the overflow fallback, the CLI under each
    codec, auto's probe, decode and encode times, wire bytes), ialm_rpca's
    device solver against the host_svd oracle, localize_window_debug
    against K1, and three corpus scenes card == CPU."""
    import swiftwatcher_tpu_torch.__main__ as main_mod
    from swiftwatcher_tpu_torch import ui
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io import native, wirecodec
    from swiftwatcher_tpu_torch.io.prefetch import WindowPrefetcher
    from swiftwatcher_tpu_torch.io.source import ArraySource, LoopingArraySource
    from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
    from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter
    from swiftwatcher_tpu_torch.ops.rpca import ialm_rpca
    from swiftwatcher_tpu_torch.pipeline.window import localize_window, localize_window_debug

    B, T, H, W = gray_dev.shape
    raw = gray_dev.reshape(B * T, H, W)
    frame_bytes = H * W
    cap4 = min(cfg.wire_escape_cap, max(1024, (gray.size - frame_bytes) // 16))

    # 16a: each format at the main path's shape, decoded on the card
    engaged = "C twin (csrc/wire_encode.cpp)" if native.has_symbol("swt_encode_delta6") \
        else "numpy (no g++ build here)"
    fmts = {"delta4": lambda: wirecodec.encode_delta4(gray, WIDE_ESCAPE_CAP),
            "delta6 mode 0": lambda: wirecodec.encode_delta6(gray, WIDE_ESCAPE_CAP, 0),
            "delta6 mode 1": lambda: wirecodec.encode_delta6(gray, WIDE_ESCAPE_CAP, 1)}
    packets, uploaded = {}, {}
    for name, enc in fmts.items():
        pkt = enc()
        check(pkt is not None, f"{name}: the close-pass batch overflowed {WIDE_ESCAPE_CAP}")
        put = wirecodec.device_put_packet6 if name != "delta4" else wirecodec.device_put_packet
        packets[name], uploaded[name] = pkt, put(pkt, dev)
        out = wirecodec.decode_packet(uploaded[name])
        check(out.dtype == torch.uint8 and torch.equal(out, raw),
              f"{name}: the decode on the card differs from the raw batch")
    auto_pkt = wirecodec.encode_delta6(gray, WIDE_ESCAPE_CAP)
    escapes = {name: int(np.count_nonzero(p.esc_idx < (gray.size - frame_bytes
                                                       if name == "delta4" else gray.size)))
               for name, p in packets.items()}
    print(f"phase 16 wire codec at {tuple(raw.shape)} (the close-pass batch): delta4, delta6 "
          f"mode 0 and mode 1 decoded on the card bit-equal to the raw batch (escape cap "
          f"{WIDE_ESCAPE_CAP}; sparse escapes {escapes}; at the default "
          f"{cfg.wire_escape_cap} the batch overflows: delta4 "
          f"{wirecodec.encode_delta4(gray, cap4) is None}, delta6 "
          f"{wirecodec.encode_delta6(gray, cfg.wire_escape_cap) is None}); delta6 picks mode "
          f"{auto_pkt.mode}; encoder {engaged}", flush=True)

    # 16b: i.i.d. noise overflows both default caps and ships raw
    noise = np.random.default_rng(16).integers(0, 256, (B * T, H, W, 3), np.uint8)
    noise_gray = bgr_to_gray_host(noise)
    shipped = {}
    for codec in ("delta4", "delta6"):
        pf = WindowPrefetcher(ArraySource(noise, fps=30.0), ((0, 0), (W, H)), dev,
                              dataclasses.replace(cfg, wire_codec=codec))
        batch = pf.next()
        pf.close()
        shipped[codec] = (type(batch[0]).__name__, dict(pf.batches_by_format))
        check(isinstance(batch[0], torch.Tensor) and pf.batches_by_format["raw"] == 1
              and pf.bytes_uploaded == B * T * H * W,
              f"{codec}: the noise batch did not ship raw: {shipped[codec]}")
        got = batch[0].reshape(B * T, H, W).cpu().numpy()
        check(np.array_equal(got, noise_gray), f"{codec}: raw noise batch differs")
    check(wirecodec.encode_delta4(noise_gray, cap4) is None
          and wirecodec.encode_delta6(noise_gray, cfg.wire_escape_cap) is None,
          "the noise batch fits an escape cap")
    print(f"phase 16 an i.i.d.-noise batch overflows both caps (delta4 {cap4}, delta6 "
          f"{cfg.wire_escape_cap}) and ships raw: {shipped}", flush=True)

    # 16d: auto's link probe and its decision
    pf = WindowPrefetcher(ArraySource(small.frames, fps=small.fps), ((0, 0), (64, 64)), dev, cfg)
    pf.close()
    rate = pf.link_bytes_per_s
    print(f"phase 16 wire_codec=auto: best of 3 round trips of 2 MiB to the card and back "
          f"{rate / 1e6:.1f} MB/s against wire_auto_mbps {cfg.wire_auto_mbps}: "
          f"{pf.codec or 'raw'} [{card}]", flush=True)
    check(pf.codec is None, "auto engaged the codec on the card's link")
    n_batches = n_frames // (B * T)
    check(r6.metrics.wire_bytes == n_batches * B * T * frame_bytes,
          f"the default run shipped {r6.metrics.wire_bytes} bytes, not raw")

    # 16c: the CLI on the close-pass clip (1008 frames, phase 6's source)
    # under each codec, against its raw run
    real_open, real_run = main_mod.open_source, main_mod.run_video
    with tempfile.TemporaryDirectory() as tmp:
        clip = Path(tmp) / "close_pass.npy"
        ui.save_corners_to_file(clip, bench.corners)
        results = {}
        runs = (("raw", []),
                ("delta6", ["--set", "wire_codec=delta6", "--set",
                            f"wire_escape_cap={WIDE_ESCAPE_CAP}"]),
                ("delta4", ["--set", "wire_codec=delta4", "--set",
                            f"wire_escape_cap={WIDE_ESCAPE_CAP}"]),
                ("delta6, default cap", ["--set", "wire_codec=delta6"]))
        try:
            main_mod.open_source = lambda path, start=0, end=0: LoopingArraySource(
                bench.frames, total=n_frames, fps=bench.fps)
            for name, flags in runs:
                rec = []

                def recorded(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = real_run(*a, **k)
                    torch.cuda.synchronize()
                    rec.append((r, time.perf_counter() - t0))
                    return r

                main_mod.run_video = recorded
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = main_mod.main(["--filepaths", str(clip), *flags])
                check(rc == 0, f"CLI with {name} exited {rc}")
                out = clip.parent / clip.stem
                results[name] = (rec[0][0], rec[0][1],
                                 {p.name: p.read_bytes() for p in sorted(out.glob("*.csv"))})
                for p in out.glob("*.csv"):
                    p.unlink()
        finally:
            main_mod.open_source, main_mod.run_video = real_open, real_run
    base, _, base_csvs = results["raw"]
    check(len(base_csvs) == 6 and [e.frame_number for e in base.events]
          == [e.frame_number for e in r11.events] and len(base.events) == len(r6.events),
          "the raw CLI run differs from phase 6/11's events")
    raw_bytes = n_batches * B * T * frame_bytes
    for name, (r, secs, csvs) in results.items():
        check([e.frame_number for e in r.events] == [e.frame_number for e in base.events]
              and csvs == base_csvs, f"CLI with {name}: events or CSVs differ from the raw run")
        wb = r.metrics.wire_bytes
        check((wb == raw_bytes) == (name in ("raw", "delta6, default cap")),
              f"CLI with {name}: shipped {wb} bytes (raw {raw_bytes})")
        print(f"phase 16 CLI on the close-pass clip, {name}: {len(r.events)} events, six CSVs "
              f"byte-equal to the raw run's, {r.frames_processed / secs:.1f} frames/s, "
              f"wire bytes {wb} ({wb / n_frames:.1f} per frame; raw {frame_bytes}) [{card}]",
              flush=True)

    # 16e: decode and encode times a batch, wire bytes a frame
    times = []
    for name, up in uploaded.items():
        ms = time_ms(torch, lambda up=up: wirecodec.decode_packet(up), 5, f"decode {name}")
        times.append(f"{name} decode {ms:.4f} ms")
    enc_ms = {}
    for name, enc in fmts.items():
        t0 = time.perf_counter()
        for _ in range(3):
            enc()
        enc_ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    real_has = native.has_symbol
    native.has_symbol = lambda name: False
    try:
        np_ms = {}
        for name, enc in fmts.items():
            t0 = time.perf_counter()
            enc()
            np_ms[name] = (time.perf_counter() - t0) * 1e3
    finally:
        native.has_symbol = real_has
    pinned = torch.from_numpy(gray).pin_memory()
    upload_ms = time_ms(torch, lambda: pinned.to(dev, non_blocking=True), 5, "raw upload")
    print(f"phase 16 a batch of {B * T} frames: " + ", ".join(times)
          + f"; raw upload from pinned memory {upload_ms:.4f} ms [{card}]", flush=True)
    print("phase 16 encode a batch on the host, " + ", ".join(
        f"{name}: {engaged.split(' (')[0]} {enc_ms[name]:.1f} ms, numpy {np_ms[name]:.1f} ms"
        for name in fmts) + f" ({os.cpu_count()} cores)", flush=True)
    print("phase 16 wire bytes a frame (the close-pass batch, escape cap "
          f"{WIDE_ESCAPE_CAP}): raw {frame_bytes}, " + ", ".join(
              f"{name} {p.nbytes / (B * T):.1f}" for name, p in packets.items()), flush=True)

    # 16f: ialm_rpca on one window, device solver vs host_svd, f64 on the card
    X = gray_dev[0].reshape(T, H * W).transpose(0, 1).to(torch.float64).contiguous()
    t0 = time.perf_counter()
    A, E, it = ialm_rpca(X, method="device")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    hA, hE, hit = ialm_rpca(X, method="host_svd")
    t_host = time.perf_counter() - t0
    dA, dE = float((A - hA).abs().max()), float((E - hE).abs().max())
    A32, E32, it32 = ialm_rpca(X.float(), method="device")
    hA32, hE32, hit32 = ialm_rpca(X.float(), method="host_svd")
    print(f"phase 16 ialm_rpca on one {H}x{W}x{T} window, f64 on the card: device {it} "
          f"iterations in {t_dev:.2f} s, host_svd {hit} in {t_host:.2f} s, max |dA| {dA:.3g}, "
          f"max |dE| {dE:.3g} (bound {IALM_F64_ATOL}); f32: iterations {it32} vs {hit32}, "
          f"max |dA| {float((A32 - hA32).abs().max()):.3g}, max |dE| "
          f"{float((E32 - hE32).abs().max()):.3g} [{card}]", flush=True)
    check(it == hit and dA <= IALM_F64_ATOL and dE <= IALM_F64_ATOL,
          "ialm_rpca: the device solver differs from the host_svd oracle")

    # 16g: localize_window_debug's opened plane == K1 on its RPCA plane
    (x1, y1), (x2, y2) = crop_region_from_corners(bench.corners, cfg)
    crop = torch.from_numpy(bench.frames[-T:, y1:y2, x1:x2]).to(dev)      # frames 57-60 in it
    table, stages, it_dbg = localize_window_debug(crop, cfg)
    k1 = fused_motion_filter(stages["RPCA"], cfg)
    check(torch.equal(k1, stages["opened"]), "localize_window_debug: opened differs from K1")
    t_single, labels_single, it_single = localize_window(crop, cfg)
    check(torch.equal(t_single.valid, table.valid) and int(it_single) == int(it_dbg),
          "localize_window and localize_window_debug disagree")
    print(f"phase 16 localize_window_debug on the close-pass window ({tuple(crop.shape)}): "
          f"opened bit-equal to K1 on its RPCA plane, {int(stages['opened'].gt(0).sum())} "
          f"pixels on, {int(table.valid.sum())} segments, {int(it_dbg)} iterations; "
          f"localize_window gives the same table", flush=True)

    # 16h: three corpus scenes, card == CPU
    corpus = tool_module("torch_accuracy_corpus")
    names = ["crowded", "jitter2", "flyby_trap"]
    got = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        got.append((corpus.score_corpus(names, where, variants=False)[0]["scenes"],
                    time.perf_counter() - t0))
    (on_card, card_s), (on_cpu, cpu_s) = got
    for name in names:
        a, b = on_card[name], on_cpu[name]
        keys = ("events_detected", "event_frames", "predicted", "rejected")
        check(all(a[k] == b[k] for k in keys), f"corpus {name}: card differs from the CPU")
        check(a["gt_entries"] == b["gt_entries"] > 0, f"corpus {name}: no ground truth")
    print("phase 16 corpus scenes card == CPU (totals and event frames): " + ", ".join(
        f"{n} gt {on_card[n]['gt_entries']} events {on_card[n]['event_frames']} detection F1 "
        f"{on_card[n]['detection']['f1']}" for n in names)
        + f"; {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU [{card}]", flush=True)


# bench_torch.py's stdout rates, each of which must be positive on the card
BENCH_RATES = ("value", "e2e_median", "classified_frames_per_sec", "resident_frames_per_sec",
               "resident_tracked_frames_per_sec", "resident_tracked_fixed_rpca_frames_per_sec",
               "sharded_resident_frames_per_sec", "e2e_from_container_fps")


def run_script(argv, timeout: float):
    """A script of this checkout in a process of its own: (stdout lines,
    stderr lines, seconds); fails on a nonzero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), proc.stderr.splitlines(), secs


def phase17(dev, cfg, card) -> None:
    """bench_torch.py and tools/torch_soak.py on the card, at cut sizes."""
    from swiftwatcher_tpu_torch.io.source import LoopingArraySource
    from swiftwatcher_tpu_torch.io.synthetic import make_video
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    frames = 2 * cfg.batch_windows * cfg.window_size
    out, err, secs = run_script(
        ["bench_torch.py", "--frames", str(frames), "--warmup-frames", str(frames // 2),
         "--resident-frames", "1344", "--sharded-frames", "1344", "--container-loops", "4"],
        timeout=300)
    details = [json.loads(s)["detail"] for s in err if s.startswith('{"detail"')]
    check(len(out) == 1 and len(details) == 1,
          f"bench_torch.py: want one stdout line and one detail line, got {len(out)} and "
          f"{len(details)}")
    line, d = json.loads(out[0]), details[0]
    print(f"phase 17 bench_torch.py in {secs:.1f} s [{card}]: " + ", ".join(
        f"{k} {line[k]}" for k in BENCH_RATES) + f" frames/s; sharded mesh "
        f"{line['sharded_mesh']}; from-container {d['from_container_codec']} on "
        f"{d['from_container_backend']}, samples {d['from_container_samples_fps']}; host decode "
        f"{d['host_decode_fps_by_backend']}; e2e samples {d['e2e_samples_fps']}, classify "
        f"samples {d['classified_samples_fps']}", flush=True)
    for name, r in {**d["resident"], "sharded_resident": d["sharded_resident"]}.items():
        print(f"phase 17 {name}: {r['fps']} frames/s by the host clock, {r['device_fps']} by "
              f"CUDA events, {r['batches']} batches of {r['batch_windows']} windows, peak device "
              f"memory {r['peak_mib']} MiB [{card}]", flush=True)
    print(f"phase 17 bench_torch.py launches by mode: {d['launches']}", flush=True)
    check(all(line[k] is not None and line[k] > 0 for k in BENCH_RATES),
          f"bench_torch.py: a rate is not positive: {[(k, line[k]) for k in BENCH_RATES]}")
    check(d["from_container_counts_equal"] is True,
          "bench_torch.py: the from-container counts differ from the decoded frames' run")
    check(d["card"] == card, f"bench_torch.py names another card: {d['card']}")
    check(d["events"] > 0, "bench_torch.py found no events")
    for mode, names in (("e2e", ("fused_motion_filter", "label_rank_fused", "track_window")),
                        ("resident", ("fused_motion_filter", "label_rank_fused")),
                        ("resident_tracked", ("fused_motion_filter", "label_rank_fused",
                                              "track_window"))):
        check(all(d["launches"][mode].get(k, 0) > 0 for k in names),
              f"bench_torch.py {mode}: {names} not all launched: {d['launches'][mode]}")
    video = make_video(seed=0, n_frames=63, H=1080, W=1920, n_entering=2, n_crossing=1,
                       n_vanishing=1)
    ref = run_video(LoopingArraySource(video.frames, total=frames, fps=video.fps),
                    video.corners, cfg, dev)
    check((d["predicted"], d["rejected"]) == (ref.total_predicted, ref.total_rejected),
          f"bench_torch.py counts {d['predicted']} / {d['rejected']} differ from the host "
          f"tracker's {ref.total_predicted} / {ref.total_rejected}")
    print(f"phase 17 bench_torch.py counts equal the host tracker's on the card: "
          f"{d['predicted']} predicted / {d['rejected']} rejected, {d['events']} events",
          flush=True)

    out, _, secs = run_script(["tools/torch_soak.py", "--loops", "2", "--min-passes", "2"],
                              timeout=180)
    rows = [json.loads(s) for s in out]
    summary = rows[-1]
    for r in rows[:-1]:
        print(f"phase 17 soak pass {r['pass']}: {r['frames']} frames at {r['fps']} frames/s, "
              f"counts scale exactly {r['counts_scale_exactly']}, RSS {r['rss_mb_after']} MB, "
              f"device {r['device_mem']} [{card}]", flush=True)
    check(summary["passes"] == 2 and summary["counts_scale_exactly"],
          f"torch_soak.py: {summary['passes']} passes, counts scale exactly "
          f"{summary['counts_scale_exactly']}")
    check(all(r["device_mem"] for r in rows[:-1]), "torch_soak.py read no device memory")
    print(f"phase 17 soak: {summary['passes']} passes in {secs:.1f} s, "
          f"{summary['events_per_loop']} events a loop", flush=True)


DECODE_FLOOR_MODES = {"null", "gray_crop", "full_bgr", "cv2"}


def phase18(np, torch, dev, cfg, card) -> None:
    """The five campaign and measurement tools on the card, in this process
    (the launch counters of K1, K2 and T1 are read around them)."""
    from swiftwatcher_tpu_torch.io import native_av
    from swiftwatcher_tpu_torch.io.source import ArraySource
    from swiftwatcher_tpu_torch.io.synthetic import make_video
    from swiftwatcher_tpu_torch.ops.ccl_local import converge_frames
    from swiftwatcher_tpu_torch.ops.ccl_sweep import sweep_chunk
    from swiftwatcher_tpu_torch.ops.fused_motion import fused_motion_filter
    from swiftwatcher_tpu_torch.ops.ialm_front import ialm_front
    from swiftwatcher_tpu_torch.ops.rank_compact import label_rank_fused, rank_seed_sweep
    from swiftwatcher_tpu_torch.pipeline import tracking_device as td
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    # every kernel's wrapper: which of them each tool launches (PERF.md §6)
    wrappers = {w.__name__: w for w in (fused_motion_filter, label_rank_fused, sweep_chunk,
                                        converge_frames, rank_seed_sweep, ialm_front,
                                        td.track_window)}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def read():
        return {k: w.launches for k, w in wrappers.items()}

    # 18.1 the counts gate of rpca_fixed_iters=15 over the parity-fuzz
    # stream, device and host trackers in turn
    rfc = tool_module("torch_rpca_fixed_counts")
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = rfc.run_campaign(scenes=4, device=dev)
    secs = time.perf_counter() - t0
    launches = read()
    for r in summary["results"]:
        print(f"phase 18 rpca_fixed_counts scene {r['scene']} ({r['tracker']} tracker, "
              f"{r['params']['n_frames']} frames at {r['params']['H']}x{r['params']['W']}): "
              f"dynamic {r['dynamic']}, fixed {r['fixed']}, ok {r['ok']}", flush=True)
    print(f"phase 18 rpca_fixed_counts: {summary['scenes']} scenes, {summary['mismatches']} "
          f"mismatches, {secs:.1f} s [{card}]; launches {launches}", flush=True)
    check(summary["scenes"] == 4 and summary["mismatches"] == 0,
          f"torch_rpca_fixed_counts: {summary['mismatches']} mismatches")
    check(all(launches[k] > 0 for k in ("fused_motion_filter", "label_rank_fused",
                                         "track_window")),
          f"torch_rpca_fixed_counts: K1, K2 and T1 not all launched: {launches}")
    counts = importlib.import_module("torch_parity_fuzz")._counts
    for r in summary["results"][:2]:
        video = make_video(**r["params"])
        on_cpu = counts(run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg,
                                  torch.device("cpu"), tracker_impl=r["tracker"]))
        check(on_cpu == r["dynamic"],
              f"torch_rpca_fixed_counts scene {r['scene']}: card {r['dynamic']}, CPU {on_cpu}")
    print("phase 18 rpca_fixed_counts: the dynamic counts of scenes 0 and 1 equal run_video's "
          "on the CPU", flush=True)

    # 18.2 ms per IALM trip at full width: 16 windows of the 216 x 432 crop
    br = tool_module("torch_bench_rpca")
    X = br.make_batch(16, dev)
    check(tuple(X.shape) == (16, cfg.window_size, 216 * 432),
          f"torch_bench_rpca batch {tuple(X.shape)}")
    pass_mb, floor_ms = br.pass_floor(X)
    print(f"phase 18 bench_rpca at {tuple(X.shape)}: one f32 pass = {pass_mb:.1f} MB, "
          f"{floor_ms:.4f} ms at {br.HBM_BYTES_PER_S / 1e12:.2f} TB/s [{card}]", flush=True)
    reset()
    rows = br.run_variants(X, ["production", "warm", "cold"], reps=3)
    launches = read()
    for r in rows:
        print(f"phase 18 bench_rpca {br.format_row(r, floor_ms).strip()}; host samples "
              f"{r.get('samples_ms')} ms [{card}]", flush=True)
    print(f"phase 18 bench_rpca launches {launches}", flush=True)
    check(all(r["ms"] > 0 and r["event_ms"] > 0 and 0 < r["trips"] <= cfg.rpca_max_iter
              for r in rows),
          f"torch_bench_rpca: a variant failed: {rows}")
    check(launches["ialm_front"] == 0,
          f"torch_bench_rpca launched K6 {launches['ialm_front']} times (its variants keep it off)")
    del X

    # 18.3 the sharded path's scaling: (1, 1) on NCCL and two ranks on gloo
    # sharing the card
    ms = tool_module("torch_mesh_scaling")
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sc = ms.scaling([1, 2], per_device_windows=2, iters=2, repeats=3, device=dev,
                        timeout=600)
    secs = time.perf_counter() - t0
    launches = read()
    for r in sc["results"]:
        print(f"phase 18 mesh_scaling data={r['data_devices']}: {r['windows_per_sec']} "
              f"windows/s ({r['frames_per_sec']} frames/s), samples {r['elapsed_samples_s']} s, "
              f"spread {r['spread_pct']}%, unsharded {r['unsharded_samples_s']} s, overhead "
              f"{r['sharded_overhead_x']}x, total vs 1 {r['total_throughput_vs_1dev']} [{card}]",
              flush=True)
    for r in sc["model_axis_results"]:
        print(f"phase 18 mesh_scaling model={r['model_devices']} ({r['total_windows']} windows): "
              f"samples {r['elapsed_samples_s']} s, spread {r['spread_pct']}%, unsharded "
              f"{r['unsharded_same_batch_s']} s, overhead {r['sharded_overhead_x']}x [{card}]",
              flush=True)
    print(f"phase 18 mesh_scaling: {sc['substrate']}; {secs:.1f} s; rank 0 launches "
          f"{launches}", flush=True)
    points = sc["results"] + sc["model_axis_results"]
    check(len(points) == 4 and all(
        r["elapsed_s"] > 0 and r["unsharded_same_batch_s"] > 0 and r["sharded_overhead_x"] > 0
        for r in points) and all(r["windows_per_sec"] > 0 for r in sc["results"]),
        f"torch_mesh_scaling: a point is not positive: {points}")
    check(sc["mesh_backends"] == {"data=1": "nccl", "data=2": "gloo", "model=1": "nccl",
                                  "model=2": "gloo"},
          f"torch_mesh_scaling backends {sc['mesh_backends']}, want NCCL for one rank and "
          "gloo for two sharing the card")
    check(launches["fused_motion_filter"] > 0 and launches["label_rank_fused"] > 0,
          f"torch_mesh_scaling: K1 and K2 not launched on rank 0: {launches}")

    # 18.4 the host decode floor: exit 2 and its error line where the
    # port's libav library is not built (the card's machine has none)
    df = tool_module("torch_decode_floor")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = df.main(["--frames", "63", "--passes", "1"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"phase 18 decode_floor: exit {rc}, {json.dumps(line)} [{card}]", flush=True)
    if native_av.is_available():
        check(rc == 0 and set(line["fps"]) == DECODE_FLOOR_MODES
              and all(v > 0 for v in line["fps"].values()),
              f"torch_decode_floor: exit {rc}, {line}")
    else:
        check(rc == 2 and line.get("error") in ("native av lib unavailable",
                                                 "no H.264 encoder"),
              f"torch_decode_floor without libav: exit {rc}, {line}")

    # 18.5 the accuracy pack against the defaults at one fresh seed
    ss = tool_module("torch_accuracy_seed_sweep")
    out = io.StringIO()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = ss.main(["--seeds", "1", "--scenes", "crowded", "jitter2", "--json", "-"])
    secs = time.perf_counter() - t0
    launches = read()
    sweep = json.loads(out.getvalue())
    for name, scene in sweep["scenes"].items():
        for row in scene.get("seeds", []):
            print(f"phase 18 seed_sweep {name} seed {row['seed']}: " + ", ".join(
                f"{kind} F1 {row[kind]['base_f1']} -> {row[kind]['pack_f1']}"
                for kind in ss.KINDS) + f" [{card}]", flush=True)
    print(f"phase 18 seed_sweep AVG {json.dumps(sweep.get('AVG'))}; {secs:.1f} s; launches "
          f"{launches}", flush=True)
    check(launches["fused_motion_filter"] > 0 and launches["label_rank_fused"] > 0,
          f"torch_accuracy_seed_sweep: K1 and K2 not launched: {launches}")
    check(rc == 0 and set(sweep["scenes"]) == {"crowded", "jitter2"}
          and all(len(s.get("seeds", [])) == 1 for s in sweep["scenes"].values())
          and set(sweep.get("AVG", {})) == set(ss.KINDS),
          f"torch_accuracy_seed_sweep: exit {rc}, scenes {list(sweep['scenes'])}, "
          f"AVG {sweep.get('AVG')}")


def k7_barriers(n: int, sweeps: int, steps: int) -> int:
    """The block-wide barriers K7 (csrc/refined_eigh.cu) crosses on one
    n x n matrix that takes `sweeps` sweeps and `steps` Newton steps: two
    reductions at the start (2 each), a reduction before each sweep and
    after the last (2 each), m - 1 steps a sweep (m = n padded to even), 2
    for the sort, and a Newton step's 4 products plus its QR's n + 1."""
    m = n + n % 2
    return 4 + 2 * (sweeps + 1) + sweeps * (m - 1) + 2 + steps * (4 + n + 1)


def k7_errors(np, G, d, V):
    """(||V^T V - I||, ||G V - V diag d|| / ||G||, max |d - eig| / max|eig|)
    of each matrix of a batch, against numpy's float64 eigh: three arrays."""
    G64, d64, V64 = (np.asarray(a, np.float64) for a in (G, d, V))
    n = G64.shape[-1]
    w = np.linalg.eigvalsh(G64)
    VT = np.swapaxes(V64, -1, -2)
    orth = np.linalg.norm(VT @ V64 - np.eye(n), axis=(-2, -1))
    gn = np.maximum(np.linalg.norm(G64, axis=(-2, -1)), 1e-300)
    resid = np.linalg.norm(G64 @ V64 - V64 * d64[..., None, :], axis=(-2, -1)) / gn
    top = np.maximum(np.abs(w).max(axis=-1), 1e-300)
    evals = np.abs(np.sort(d64, axis=-1) - w).max(axis=-1) / top
    return orth, resid, evals


def k7_subspace_sin(np, G, d, V, d0, V0, gap: float = 1e-3):
    """The largest sin of the angle between K7's and the reference's
    eigenvector of each eigenvalue that stands apart from the others by
    more than gap * max|eig| (numpy's float64 eigh): columns matched by
    nearest d.  0 where no eigenvalue stands apart."""
    G64 = np.asarray(G, np.float64)
    worst = 0.0
    for g, dk, vk, dr, vr in zip(G64, d, V, d0, V0):
        w = np.linalg.eigvalsh(g)
        scale = max(np.abs(w).max(), 1e-300)
        for lam in w:
            others = np.abs(w - lam)
            if np.sort(others)[1] <= gap * scale:
                continue
            a = vk[:, np.argmin(np.abs(dk - lam))].astype(np.float64)
            b = vr[:, np.argmin(np.abs(dr - lam))].astype(np.float64)
            cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            worst = max(worst, float(np.sqrt(max(0.0, 1.0 - cos * cos))))
    return worst


def k7_synthetic(np, rng, B: int = 16, n: int = 21) -> dict:
    """tests/test_torch_refined_eigh.py's kinds of Gram, (B, n, n) f32 each:
    random SPD, clustered spectra, u8 windows at the cells' crop (P =
    93312, a dark blob over a few frames), exactly rank 1, all zero."""
    X = rng.standard_normal((B, n, 3 * n))
    out = {"spd": X @ np.swapaxes(X, 1, 2)}
    clustered = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = n // 3
        ev = np.r_[np.full(k, 1.0), np.full(k, 1.0 + 1e-6), np.linspace(2.0, 3.0, n - 2 * k)]
        clustered.append((Q * ev) @ Q.T)
    out["clustered"] = np.asarray(clustered)
    u8 = []
    for _ in range(4):
        bg = rng.integers(60, 200, 93312).astype(np.float64)
        M = bg[None, :] + rng.normal(0.0, rng.uniform(1.0, 4.0), (n, 93312))
        s = rng.integers(0, 93312 - 2000)
        for t in range(5, 9):
            M[t, s + 200 * t: s + 200 * t + 300] = 20.0
        M = np.clip(np.round(M), 0, 255)
        u8.append(M @ M.T)
    out["u8_window"] = np.asarray(u8)
    v = rng.standard_normal((B, n)) * rng.uniform(1.0, 1e4, (B, 1))
    out["rank1"] = v[:, :, None] * v[:, None, :]
    out["zero"] = np.zeros((2, n, n))
    return {k: np.asarray(g, np.float32) for k, g in out.items()}


def k7_main_path(r, launches: int, batch: int, what: str) -> None:
    """K7 on a warm run_video's path: launched once a trip and once for the
    seed of each batch's basis (the sum over batches of the slowest
    window's iterations + 1), each in an `ialm_eigh` span, and no refined
    eigh left on the synchronising plain chain (`sync.ialm_eigh`)."""
    it = list(r.ialm_iters)
    want = sum(max(it[i:i + batch]) + 1 for i in range(0, len(it), batch))
    c = r.metrics.counters
    print(f"{what} K7 launches {launches} (trips + batches {want}); counters ialm_eigh "
          f"{c.get('ialm_eigh', 0)}, sync.ialm_eigh {c.get('sync.ialm_eigh', 0)}", flush=True)
    check(launches == want == c.get("ialm_eigh", 0),
          f"{what}: K7 launched {launches} times, want trips + batches = {want} "
          f"(ialm_eigh spans {c.get('ialm_eigh', 0)})")
    check(c.get("sync.ialm_eigh", 0) == 0,
          f"{what}: {c.get('sync.ialm_eigh')} refined eighs took the synchronising plain "
          "chain")


def k7_round_ns(torch, build, dev, threads: int, steps: int = 1 << 16) -> float:
    """Nanoseconds a round of csrc/k7_latency.cu's micro-kernel
    (one block of `threads`; CUDA events around one launch, after a
    warm-up): the least a K7 barrier step costs."""
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    args = ("k7_latency", "swt_k7_latency", dev, threads, steps, 0, out.data_ptr())
    build.launch(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    build.launch(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e6 / steps


def phase19(np, torch, dev, cfg, card, gray_dev) -> dict:
    """K7 (csrc/refined_eigh.cu) against refined_eigh_reference on the card:
    on the Grams of every refined eigh of a warm solve of the 1080p batch
    (the seed's and each trip's C, captured from the plain chain as phase 7
    captures K6's operands) and on the synthetic set; the warm solve with
    K7 against the plain chain; the sweeps; the times.  Returns K7's entry
    for the kernels line."""
    from swiftwatcher_tpu_torch import build
    from swiftwatcher_tpu_torch.ops import ialm_trip as k8_mod
    from swiftwatcher_tpu_torch.ops import rpca as rpca_mod
    from swiftwatcher_tpu_torch.ops.refined_eigh import (
        MAX_SWEEPS, NEWTON_STEPS, launch_refined_eigh, refined_eigh, refined_eigh_reference)

    captured = []

    def recording(G):
        captured.append(G.clone())
        return refined_eigh_reference(G)

    # the plain chain: the seed's and the trips' refined eigh, and the trips
    # off K8, all in ops/ialm_trip.py
    route = k8_mod.kernel_route
    k8_mod.refined_eigh, k8_mod.kernel_route = recording, (lambda *args: False)
    try:
        m_plain, it_plain = rpca_mod.rpca_motion_window_batched(gray_dev, cfg)
    finally:
        k8_mod.refined_eigh, k8_mod.kernel_route = refined_eigh, route
    B, n = captured[0].shape[0], captured[0].shape[-1]
    print(f"phase 19 K7 input: {len(captured)} Gram batches of {tuple(captured[0].shape)} "
          f"from a warm solve of {tuple(gray_dev.shape)} (IALM iters "
          f"{it_plain.min().item()}..{it_plain.max().item()})", flush=True)

    def compare(G, what, resid_limit=1e-5, sin_limit=1e-3):
        d, V, sw = launch_refined_eigh(G)
        d2, V2, sw2 = launch_refined_eigh(G)
        d0, V0 = refined_eigh_reference(G)
        torch.cuda.synchronize()
        check(torch.equal(d, d2) and torch.equal(V, V2) and torch.equal(sw, sw2),
              f"K7 differs between two launches on {what}")
        Gh, dh, Vh = G.cpu().numpy(), d.cpu().numpy(), V.cpu().numpy()
        check(bool(np.isfinite(dh).all() and np.isfinite(Vh).all()), f"K7 non-finite on {what}")
        orth, resid, evals = k7_errors(np, Gh, dh, Vh)
        r_orth, r_resid, r_evals = k7_errors(np, Gh, d0.cpu().numpy(), V0.cpu().numpy())
        sin = k7_subspace_sin(np, Gh, dh, Vh, d0.cpu().numpy(), V0.cpu().numpy())
        check(orth.max() <= 1e-5 and resid.max() <= resid_limit and evals.max() <= 1e-5
              and sin <= sin_limit,
              f"K7 on {what}: orth {orth.max():.3g}, resid {resid.max():.3g} (limit "
              f"{resid_limit}), evals {evals.max():.3g}, subspace sin {sin:.3g}")
        return dict(orth=float(orth.max()), resid=float(resid.max()), evals=float(evals.max()),
                    sin=sin, ref_orth=float(r_orth.max()), ref_resid=float(r_resid.max()),
                    ref_evals=float(r_evals.max()), sweeps=sw.cpu().numpy())

    rows = {}
    rows["solve"] = [compare(G, f"the solve's Gram batch {k}") for k, G in enumerate(captured)]
    rng = np.random.default_rng(19)
    for kind, G in k7_synthetic(np, rng, B, n).items():
        # rank 1: the Newton steps' cluster test cannot see f32 noise, and
        # both routes tilt the top eigenvector by up to ~1e-3 (the test file)
        rank1 = kind == "rank1"
        rows[kind] = [compare(torch.from_numpy(G).to(dev), kind, 1e-2 if rank1 else 1e-5,
                              1e-2 if rank1 else 1e-3)]
        if kind == "zero":
            d, V, sw = launch_refined_eigh(torch.from_numpy(G).to(dev))
            check(bool((d == 0).all()) and torch.equal(V, torch.eye(n, device=dev).expand_as(V))
                  and bool((sw == 0).all()), "K7 on the zero Gram: want d = 0, V = I, 0 sweeps")
    for kind, rs in rows.items():
        sw = np.concatenate([r["sweeps"] for r in rs])
        print(f"phase 19 K7 vs f64 eigh on {kind} ({len(rs)} x {B if kind != 'zero' else 2}): "
              f"orth {max(r['orth'] for r in rs):.3g} (plain {max(r['ref_orth'] for r in rs):.3g}), "
              f"resid {max(r['resid'] for r in rs):.3g} (plain {max(r['ref_resid'] for r in rs):.3g}), "
              f"evals {max(r['evals'] for r in rs):.3g} (plain {max(r['ref_evals'] for r in rs):.3g}); "
              f"subspace sin vs plain {max(r['sin'] for r in rs):.3g}; sweeps max {sw.max()} "
              f"median {float(np.median(sw))}; bit-identical in two launches", flush=True)
    solve_sweeps = np.concatenate([r["sweeps"] for r in rows["solve"]])
    check(int(solve_sweeps.max()) < MAX_SWEEPS, "K7 hit its sweep cap on the solve's Grams")

    # the warm solve with K7 against the plain chain
    before = refined_eigh.launches
    m_k7, it_k7 = rpca_mod.rpca_motion_window_batched(gray_dev, cfg)
    torch.cuda.synchronize()
    k7_calls = refined_eigh.launches - before
    it_diff = int((it_k7 - it_plain).abs().max())
    mot_diff = int((m_k7.int() - m_plain.int()).abs().max())
    print(f"phase 19 warm RPCA with K7 and K8: iters {it_k7.min().item()}..{it_k7.max().item()} "
          f"(plain {it_plain.min().item()}..{it_plain.max().item()}), iters max |diff| "
          f"{it_diff}, motion max |diff| {mot_diff}, K7 launches {k7_calls} "
          f"(trips + 1 = {int(it_k7.max()) + 1})", flush=True)
    check(it_diff <= 1, "warm RPCA: K7 and the plain chain differ by more than 1 iteration")
    check(mot_diff <= 2, "warm RPCA: K7 and the plain chain differ by more than 2 u8")
    check(k7_calls == int(it_k7.max()) + 1, "warm RPCA: want one K7 launch a trip and the seed's")

    # times: K7 and the plain chain on a mid-solve Gram batch, at B and 64
    G = captured[len(captured) // 2]
    m = n + n % 2
    threads = -(-m * m // 32) * 32
    round_ns = k7_round_ns(torch, build, dev, threads)
    out = {}
    for batch in (B, 64):
        Gb = G.repeat(-(-batch // B), 1, 1)[:batch].contiguous()
        k_ms, p_ms = alternate_ms(torch, lambda: refined_eigh_reference(Gb),
                                  lambda: launch_refined_eigh(Gb), what="K7")
        sw = launch_refined_eigh(Gb)[2]
        bound_ms = k7_barriers(n, int(sw.max()), NEWTON_STEPS) * round_ns * 1e-6
        print(f"phase 19 K7 time at {tuple(Gb.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, latency bound {bound_ms:.4f} ms ({k7_barriers(n, int(sw.max()), NEWTON_STEPS)} "
              f"barrier rounds at {round_ns:.1f} ns, {int(sw.max())} sweeps) [{card}]", flush=True)
        out[batch] = (k_ms, p_ms, bound_ms)
    k_ms, p_ms, bound_ms = out[64]
    return {"name": "refined_eigh", "route": "cuda",
            "source": "swiftwatcher_tpu_torch/csrc/refined_eigh.cu",
            "replaces": "swiftwatcher_tpu/ops/rpca.py _refined_eigh (plain XLA, no pallas_call)",
            "launches": k7_calls, "max_abs_err": None,
            "resid_max": max(r["resid"] for r in rows["solve"]),
            "subspace_sin_max": max(r["sin"] for r in rows["solve"]),
            "ms": k_ms, "plain_ms": p_ms, "latency_bound_ms": bound_ms,
            "sweeps_max": int(solve_sweeps.max()),
            "sweeps_median": float(np.median(solve_sweeps))}

def k8_batch(np, torch, dev, cfg, bench, crop, B: int = 64):
    """The cells' (B, 21, 216, 432) u8 batch from the 1080p scene: window w
    starts at frame 21 w + 7 (w // 4), looping over the 63 frames."""
    (x1, y1), (x2, y2) = crop
    from swiftwatcher_tpu_torch.ops.color import bgr_to_gray_host
    T = cfg.window_size
    n = np.arange(B * T)
    idx = (n + 7 * (n // (4 * T))) % len(bench.frames)
    gray = bgr_to_gray_host(bench.frames[idx, y1:y2, x1:x2])
    return torch.from_numpy(gray.reshape(B, T, *gray.shape[1:])).to(dev)


def k8_bytes(X, A) -> int:
    """Bytes K8a and K8b move together in a trip over X's (B, T, P), A the
    state: X, A and Y read by each, A, E and Y written by K8b."""
    n, s = X.numel(), A.element_size()
    return n * (2 * (X.element_size() + 2 * s) + 3 * s)


def phase20(np, torch, dev, cfg, card, bench, crop) -> dict:
    """K8 (csrc/ialm_trip.cu, the warm trip's two kernels) against
    ialm_trip_reference on the card at the cells' (64, 21, 93312): on the
    states of a warm solve's trips captured from the plain chain; frozen
    windows; the whole solve against the plain chain; the times; and its
    launches on run_video.  Returns K8's entry for the kernels line."""
    from swiftwatcher_tpu_torch.ops import ialm_trip as k8
    from swiftwatcher_tpu_torch.ops import rpca as rpca_mod
    from swiftwatcher_tpu_torch.pipeline.runner import run_video
    from swiftwatcher_tpu_torch.io.source import LoopingArraySource

    gray = k8_batch(np, torch, dev, cfg, bench, crop)
    B, T, H, W = gray.shape
    Xs = gray.reshape(B, T, H * W)
    kw = rpca_mod.ialm_gates_and_kwargs(cfg, torch.float32, dev)
    lm, rho, cap = kw["lmbda"], kw["rho"], kw["mu_cap"]
    states = []
    plain = k8.ialm_trip_reference

    def recording(X, A_s, Y_s, mu, V0, *args):
        states.append((A_s.clone(), Y_s.clone(), mu.clone(), V0.clone()))
        return plain(X, A_s, Y_s, mu, V0, *args)

    route = k8.kernel_route
    k8.kernel_route, k8.ialm_trip_reference = (lambda *a: False), recording
    try:
        m_plain, it_plain = rpca_mod.rpca_motion_window_batched(gray, cfg)
    finally:
        k8.kernel_route, k8.ialm_trip_reference = route, plain
    torch.cuda.synchronize()
    check(states[0][0].dtype == torch.bfloat16 and Xs.dtype == torch.uint8,
          "phase 20: the shipped solve holds X as u8 and its state as bf16")
    print(f"phase 20 K8 input: {len(states)} trip states of {tuple(Xs.shape)} from a warm "
          f"solve (IALM iters {it_plain.min().item()}..{it_plain.max().item()})", flush=True)

    def bf16_gap(got, want):
        """Largest |got - want| of two bf16 tensors over max|want|."""
        w = want.float()
        return float((got.float() - w).abs().max() / w.abs().max().clamp(min=1e-30))

    worst = {"c": 0.0, "zz": 0.0, "a": 0.0, "y": 0.0}
    for k in sorted({1, len(states) // 2, len(states) - 1}):
        A_s, Y_s, mu, V0 = states[k]
        Aupd, Eupd, Ynew, _, _, Z = plain(Xs, A_s, Y_s, mu, V0, lm, rho, cap)
        W1 = V0.transpose(-1, -2) @ (Xs.float() - Eupd + (1.0 / mu)[:, None, None] * Y_s.float())
        C_plain = W1 @ W1.transpose(-1, -2)
        zz_plain = (Z * Z).sum(dim=(-2, -1))
        C = k8.launch_front(Xs, A_s, Y_s, 1.0 / mu, V0, None, lm)
        C2 = k8.launch_front(Xs, A_s, Y_s, 1.0 / mu, V0, None, lm)
        runs = []
        for _ in range(2):
            A, E, Y = A_s.clone(), torch.zeros_like(A_s), Y_s.clone()
            _, _, zz = k8.ialm_trip(Xs, A, E, Y, mu, V0, None, lm, rho, cap)
            runs.append((A, E, Y, zz))
        torch.cuda.synchronize()
        A, E, Y, zz = runs[0]
        check(torch.equal(C, C2) and all(torch.equal(p, q) for p, q in zip(*runs)),
              f"phase 20 trip {k}: K8 differs between two runs")
        check(torch.equal(E, Eupd.to(torch.bfloat16)),
              f"phase 20 trip {k}: K8's E store is not the plain chain's bit for bit")
        gaps = {"c": float((C - C_plain).abs().max() / C_plain.abs().max()),
                "zz": float(((zz - zz_plain).abs() / zz_plain).max()),
                "a": bf16_gap(A, Aupd.to(torch.bfloat16)),
                "y": bf16_gap(Y, Ynew.to(torch.bfloat16))}
        for key, v in gaps.items():
            worst[key] = max(worst[key], v)
        a_off = int((A != Aupd.to(torch.bfloat16)).sum())
        print(f"phase 20 trip {k}: E bit-equal; C {gaps['c']:.3g} of max|C| (limit "
              f"{k8.C_RTOL}), zz {gaps['zz']:.3g} (limit {k8.ZZ_RTOL}); bf16 A {gaps['a']:.3g}, "
              f"Y {gaps['y']:.3g} of max (limit {k8.STATE_RTOL:.3g}); A stores differing "
              f"{a_off} of {A.numel()}; bit-identical in two runs", flush=True)
        check(gaps["c"] <= k8.C_RTOL and gaps["zz"] <= k8.ZZ_RTOL
              and gaps["a"] <= k8.STATE_RTOL and gaps["y"] <= k8.STATE_RTOL,
              f"phase 20 trip {k}: K8 against the plain chain {gaps}")
        # frozen windows: every other window inactive
        active = torch.arange(B, device=dev) % 2 == 0
        A2, E2, Y2 = A_s.clone(), torch.zeros_like(A_s), Y_s.clone()
        E2[1::2] = 7
        _, _, zz2 = k8.ialm_trip(Xs, A2, E2, Y2, mu, V0, active, lm, rho, cap)
        torch.cuda.synchronize()
        check(torch.equal(A2[1::2], A_s[1::2]) and torch.equal(Y2[1::2], Y_s[1::2])
              and bool((E2[1::2] == 7).all()) and bool((zz2[1::2] == 0).all()),
              f"phase 20 trip {k}: K8 wrote to a frozen window")
        check(torch.equal(A2[::2], A[::2]) and torch.equal(E2[::2], E[::2])
              and torch.equal(Y2[::2], Y[::2]) and torch.equal(zz2[::2], zz[::2]),
              f"phase 20 trip {k}: K8 on the active windows differs with others frozen")
    print("phase 20 frozen windows: A, E, Y untouched bit for bit, zz 0; the active ones "
          "as in the all-active run", flush=True)

    # the whole solve on K8 against the plain chain
    before = k8.ialm_trip.launches
    m_k8, it_k8 = rpca_mod.rpca_motion_window_batched(gray, cfg)
    torch.cuda.synchronize()
    trips = k8.ialm_trip.launches - before
    it_diff = int((it_k8 - it_plain).abs().max())
    mot_diff = int((m_k8.int() - m_plain.int()).abs().max())
    print(f"phase 20 warm RPCA on K8: iters {it_k8.min().item()}..{it_k8.max().item()} "
          f"(plain {it_plain.min().item()}..{it_plain.max().item()}), iters max |diff| "
          f"{it_diff}, motion max |diff| {mot_diff} ({int((m_k8 != m_plain).sum())} px), "
          f"K8 trips {trips}", flush=True)
    check(it_diff <= 1, "phase 20: K8 and the plain chain differ by more than 1 iteration")
    check(mot_diff <= 2, "phase 20: K8 and the plain chain differ by more than 2 u8")
    check(trips == int(it_k8.max()), "phase 20: want one K8 trip a loop trip")

    # times at a mid-solve state
    A_s, Y_s, mu, V0 = states[len(states) // 2]
    inv_mu = 1.0 / mu
    A, E, Y = A_s.clone(), torch.zeros_like(A_s), Y_s.clone()
    Q = torch.eye(T, device=dev).expand(B, T, T).contiguous()
    front_ms = time_ms(torch, lambda: k8.launch_front(Xs, A_s, Y_s, inv_mu, V0, None, lm), 20,
                       "K8a")
    back_ms = time_ms(torch, lambda: k8.launch_back(Xs, A, E, Y, inv_mu, mu, V0, Q, None, lm),
                      20, "K8b")
    trip_ms, plain_ms = alternate_ms(
        torch, lambda: plain(Xs, A_s, Y_s, mu, V0, lm, rho, cap),
        lambda: k8.ialm_trip(Xs, A, E, Y, mu, V0, None, lm, rho, cap), what="the K8 trip")
    n_bytes = k8_bytes(Xs, A_s)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 20 K8 time at {tuple(Xs.shape)}: K8a {front_ms:.4f} ms, K8b {back_ms:.4f} ms "
          f"(sum {front_ms + back_ms:.4f}) against {bound_ms:.4f} ms of bytes ({n_bytes} B); the "
          f"trip with K7 and the T x T work {trip_ms:.4f} ms, the plain trip {plain_ms:.4f} ms "
          f"[{card}]", flush=True)

    # its launches on run_video at the cells' batch: one a trip, in as many spans
    cfg64 = dataclasses.replace(cfg, batch_windows=B)
    before = k8.ialm_trip.launches
    r = run_video(LoopingArraySource(bench.frames, total=2 * B * T, fps=bench.fps),
                  bench.corners, cfg64, dev)
    launches = k8.ialm_trip.launches - before
    it = list(r.ialm_iters)
    want = sum(max(it[i:i + B]) for i in range(0, len(it), B))
    spans = r.metrics.counters.get("ialm_trip", 0)
    print(f"phase 20 run_video at batch {B}: ialm_trip.launches {launches}, ialm_trip spans "
          f"{spans}, trips {want} ({r.metrics.batches} batches)", flush=True)
    check(launches == spans == want > 0,
          f"phase 20: ialm_trip.launches {launches}, spans {spans}, trips {want}")
    return {"name": "ialm_trip", "route": "cuda",
            "source": "swiftwatcher_tpu_torch/csrc/ialm_trip.cu",
            "replaces": "none: the warm trip of swiftwatcher_tpu/ops/rpca.py, plain XLA",
            "launches": launches, "max_abs_err": None, "gaps": worst,
            "ms": front_ms + back_ms, "front_ms": front_ms, "back_ms": back_ms,
            "trip_ms": trip_ms, "plain_ms": plain_ms, "bytes_bound_ms": bound_ms}


def run_phase20() -> None:
    """Phases 1, 2 and 20 alone (`chip_smoke.py --phase 20`)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device (torch.cuda.is_available() is False)")
    from swiftwatcher_tpu_torch import build
    from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
    from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda
    from swiftwatcher_tpu_torch.geometry import crop_region_from_corners
    from swiftwatcher_tpu_torch.io.synthetic import make_video

    cfg = DEFAULT_CONFIG
    dev = require_cuda()
    pin_numerics()
    card = gpu_line()
    print(card, flush=True)
    secs = build.build_all()
    print(f"phase 2 build: {secs:.2f} s", flush=True)
    bench = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    bench.frames = close_pass(np, bench.frames)
    t0 = time.perf_counter()
    k8 = phase20(np, torch, dev, cfg, card, bench,
                 crop_region_from_corners(bench.corners, cfg))
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [k8]}))


def main() -> int:
    try:
        if sys.argv[1:] == ["--phase", "20"]:
            run_phase20()
        else:
            run()
    except (SmokeFailure, ImportError, RuntimeError, ValueError, OSError,
            subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
