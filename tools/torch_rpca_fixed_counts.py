"""Counts-equality campaign for the rpca_fixed_iters option, through the
PyTorch port.

Counterpart of tools/rpca_fixed_counts.py for swiftwatcher_tpu_torch.  The
option runs the IALM solver for a fixed number of trips with no stopping
test.  Dynamic stopping spreads 13-15 iterations on the bench scene, so
windows that converge early get extra trips under the option and its
motion is not bit-equal to the shipped default's.  This campaign asks
whether that ever reaches the events: across the parity-fuzz scene stream
(tools/torch_parity_fuzz.py's generator and campaign seed, so scene
parameters line up row for row with the parity campaign), does
rpca_fixed_iters=15 change the predicted/rejected totals or any event
frame number against dynamic stopping?  Even scenes run the device
tracker, odd ones the host tracker.

Prints one JSON line per scene and a summary line; with --out, rewrites
the file after every scene; exits 1 on any mismatch.

    python tools/torch_rpca_fixed_counts.py --scenes 40 [--fixed-iters 15]
        [--campaign-seed 20260820] [--device cpu] [--out result.json]

With --window-iters it compares the refined eigendecompositions instead,
on the same scenes with dynamic stopping: each window's IALM iterations
and each scene's counts under the shipped route (ops/refined_eigh.py: K7
on a CUDA f32 solve), under the plain chain in its place
(`refined_eigh_reference`, the solver as it was before K7) and under the
f64 solver (`rpca_dtype=float64`, which takes the plain chain), so the
spread between two f32 routes can be read beside the spread between f32
and f64.  Windows are split into full ones and the partial last window of
a scene whose frames are not a multiple of the window; a mismatch is a
scene whose shipped counts differ from the plain chain's or with a window
whose iterations differ from the plain chain's by more than 1.

Runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import device_from_arg  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402


def run_campaign(scenes: int, fixed_iters: int = 15, campaign_seed: int = 20260820,
                 out: str | None = None, device=torch.device("cuda")) -> dict:
    """Dynamic IALM vs rpca_fixed_iters=fixed_iters on `scenes` scenes of the
    parity-fuzz stream, run_video on `device`; the summary (with every
    scene's row under "results")."""
    # the parity fuzz imports its oracle (cv2, scipy) with it: import here,
    # so that this module imports with the port alone
    from torch_parity_fuzz import _counts, scene_params

    rng = np.random.default_rng(campaign_seed)
    cfg_fix = dataclasses.replace(DEFAULT_CONFIG, rpca_fixed_iters=fixed_iters)
    results = []
    mismatches = 0
    t_start = time.perf_counter()

    def summarize():
        return dict(
            scenes=len(results),
            scenes_requested=scenes,
            mismatches=mismatches,
            fixed_iters=fixed_iters,
            campaign_seed=campaign_seed,
            elapsed_s=round(time.perf_counter() - t_start, 1),
            device=str(device),
            note=(
                "the port's run_video with dynamic IALM vs rpca_fixed_iters="
                f"{fixed_iters}, alternating device/host tracker; equality on "
                "predicted/rejected totals AND sorted event frame numbers.  "
                "Scene stream: tools/torch_parity_fuzz.py's generator and "
                "campaign seed."
            ),
            results=results,
        )

    for i in range(scenes):
        params = scene_params(rng, i)
        tracker = "device" if i % 2 == 0 else "host"
        video = make_video(**params)
        res_dyn = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                            DEFAULT_CONFIG, device, tracker_impl=tracker)
        res_fix = run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                            cfg_fix, device, tracker_impl=tracker)
        dyn, fix = _counts(res_dyn), _counts(res_fix)
        ok = dyn == fix
        mismatches += 0 if ok else 1
        row = dict(scene=i, tracker=tracker, ok=ok, params=params, dynamic=dyn, fixed=fix)
        print(json.dumps(row), flush=True)
        results.append(row)
        if out:  # rewritten after every scene, so a cut run keeps its rows
            Path(out).write_text(json.dumps(summarize(), indent=1))

    summary = summarize()
    print(json.dumps({"summary": {k: v for k, v in summary.items() if k != "results"}}),
          flush=True)
    if out:
        Path(out).write_text(json.dumps(summary, indent=1))
    return summary


def window_iters_campaign(scenes: int, campaign_seed: int = 20260820, out: str | None = None,
                          device=torch.device("cuda")) -> dict:
    """Dynamic IALM on `scenes` scenes of the parity-fuzz stream, three
    ways (the shipped refined eigh, the plain chain, the f64 solver),
    run_video on `device`: the summary (every scene's row under
    "results"), with the windows counted by |iterations - plain chain's|
    for the shipped and the f64 solve, full and partial windows apart."""
    from torch_parity_fuzz import _counts, scene_params

    from swiftwatcher_tpu_torch.ops import rpca
    from swiftwatcher_tpu_torch.ops.refined_eigh import refined_eigh_reference

    rng = np.random.default_rng(campaign_seed)
    cfg_f64 = dataclasses.replace(DEFAULT_CONFIG, rpca_dtype="float64", rpca_state_bf16=False)
    T = DEFAULT_CONFIG.window_size
    results = []
    mismatches = 0
    gaps = {f"{who}_{kind}": {} for who in ("shipped", "f64") for kind in ("full", "partial")}
    t_start = time.perf_counter()

    def summarize():
        return dict(
            scenes=len(results),
            scenes_requested=scenes,
            mismatches=mismatches,
            campaign_seed=campaign_seed,
            elapsed_s=round(time.perf_counter() - t_start, 1),
            device=str(device),
            windows_by_gap={k: dict(sorted(v.items())) for k, v in gaps.items()},
            note=(
                "the port's run_video with dynamic IALM: per-window iterations and counts "
                "under the shipped refined eigh, the plain chain (refined_eigh_reference) "
                "and the f64 solver; windows_by_gap counts windows by |iterations - the "
                "plain chain's|.  A mismatch: shipped counts differ from the plain "
                "chain's, or a window's iterations by more than 1.  Scene stream: "
                "tools/torch_parity_fuzz.py's generator and campaign seed."
            ),
            results=results,
        )

    for i in range(scenes):
        params = scene_params(rng, i)
        tracker = "device" if i % 2 == 0 else "host"
        video = make_video(**params)

        def run(cfg):
            return run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg,
                             device, tracker_impl=tracker)

        res = {"shipped": run(DEFAULT_CONFIG), "f64": run(cfg_f64)}
        shipped = rpca.refined_eigh
        rpca.refined_eigh = refined_eigh_reference
        try:
            res["plain"] = run(DEFAULT_CONFIG)
        finally:
            rpca.refined_eigh = shipped
        iters = {k: [int(n) for n in r.ialm_iters] for k, r in res.items()}
        partial = [False] * len(iters["plain"])
        if params["n_frames"] % T and partial:
            partial[-1] = True
        worst = 0
        for who in ("shipped", "f64"):
            for a, b, p in zip(iters[who], iters["plain"], partial):
                gap = abs(a - b)
                key = f"{who}_{'partial' if p else 'full'}"
                gaps[key][gap] = gaps[key].get(gap, 0) + 1
                if who == "shipped":
                    worst = max(worst, gap)
        counts = {k: _counts(r) for k, r in res.items()}
        ok = (counts["shipped"] == counts["plain"] and worst <= 1
              and len(iters["shipped"]) == len(iters["plain"]))
        mismatches += 0 if ok else 1
        row = dict(scene=i, tracker=tracker, ok=ok, n_frames=params["n_frames"],
                   partial_last=partial[-1] if partial else False, iters=iters, counts=counts)
        print(json.dumps(row), flush=True)
        results.append(row)
        if out:
            Path(out).write_text(json.dumps(summarize(), indent=1))

    summary = summarize()
    print(json.dumps({"summary": {k: v for k, v in summary.items() if k != "results"}}),
          flush=True)
    if out:
        Path(out).write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--fixed-iters", type=int, default=15)
    ap.add_argument("--campaign-seed", type=int, default=20260820)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--window-iters", action="store_true",
                    help="compare the refined eigh routes' window iterations instead")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    if args.window_iters:
        summary = window_iters_campaign(args.scenes, args.campaign_seed, args.out, device)
    else:
        summary = run_campaign(args.scenes, args.fixed_iters, args.campaign_seed, args.out,
                               device)
    sys.exit(1 if summary["mismatches"] else 0)


if __name__ == "__main__":
    main()
