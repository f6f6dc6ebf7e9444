"""Readings that set the limits of `correct` (swtbench/checks/<cell>.json).

    python3 -m swtbench.control --workload count.dusk --seeds 11 12 13 \
        --frames 40320 [--program] [--controls tf32] [--device cuda]

For each seed, at the cell's own size, on the first `--frames` frames of
its stream (a whole number of batches):

  --program    the program's timed path (one run_video call, as a run makes
               it) held to the float64 reference: the lower readings;
  --controls   the reference itself put in the program's place, computed
               one precision step below what the configuration states
               (TF32 products, swtbench/reference/ialm.py), held to the
               float64 reference: the upper readings.

One JSON line a reading on standard output: {"seed", "side", "numbers"}.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(cell, seeds, frames, program, controls, device, shrink=None):
    """Yield {"seed", "side", "numbers"} for each seed and side."""
    import torch

    from . import compare, traffic
    from .probe import Probe
    from .reference import run_reference
    from .run import cell_inputs, program_config, program_results
    from .source import StreamSource

    p, (H, W), corners, params, crop = cell_inputs(cell, shrink)
    T = int(p["window_size"])
    frames = frames - frames % (T * int(p["batch_windows"]))
    device = torch.device(device)
    for seed in seeds:
        clip = traffic.generate(params, seed, H, W, crop)
        ref = run_reference(clip.first_frame, clip.crops, corners, p, frames, device)
        if program:
            from swiftwatcher_tpu_torch.pipeline.runner import run_video

            B = int(p["batch_windows"])
            with Probe(device, frames // (B * T) + 1, B, T) as probe:
                res = run_video(StreamSource(clip, frames), corners, program_config(p), device,
                                tracker_impl=cell.config["tracker_impl"])
            yield {"seed": seed, "side": "program",
                   "numbers": compare.numbers(program_results(res, probe, frames), ref)}
            del res, probe
        for precision in controls:
            ctl = run_reference(clip.first_frame, clip.crops, corners, p, frames, device,
                                precision=precision)
            U, N = len(ctl["iters"]), len(ctl["segments"])
            ctl["iters"] = [ctl["iters"][k % U] for k in range(frames // T)]
            ctl["segments"] = [ctl["segments"][fn % N] for fn in range(frames)]
            if ctl["shifts"] is not None:
                ctl["shifts"] = ctl["shifts"][[fn % N for fn in range(frames)]]
            yield {"seed": seed, "side": precision, "numbers": compare.numbers(ctl, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=40320)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from . import run, spec

    run.pin_caches()
    cell = spec.load_cell(args.workload)
    worst = {}
    for r in readings(cell, args.seeds, args.frames, args.program, args.controls, args.device):
        print(json.dumps(r), flush=True)
        for k, v in r["numbers"].items():
            key = (r["side"], k)
            lo_hi = max if r["side"] == "program" else min
            worst[key] = v if key not in worst else lo_hi(worst[key], v)
    for (side, k), v in sorted(worst.items()):
        print(f"{'largest' if side == 'program' else 'smallest'} {side} {k} {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
