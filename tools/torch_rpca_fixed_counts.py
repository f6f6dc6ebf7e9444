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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--fixed-iters", type=int, default=15)
    ap.add_argument("--campaign-seed", type=int, default=20260820)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    summary = run_campaign(args.scenes, args.fixed_iters, args.campaign_seed, args.out,
                           device)
    sys.exit(1 if summary["mismatches"] else 0)


if __name__ == "__main__":
    main()
