"""Readings that set the limits of `correct` (swtbench/checks/<cell>.json).

    python3 -m swtbench.control --workload count.dusk --seeds 11 12 13 \
        --frames 40320 [--program] [--controls tf32] [--device cuda]

For each seed, at the cell's own size, on the first `--frames` frames of
its stream (a whole number of batches):

  --program    the program's timed path (one run_video call, as a run makes
               it) held to the float64 reference: the lower readings;
  --controls   the reference itself put in the program's place, computed
               one precision step below what the configuration states
               (TF32 products, swtbench/reference/ialm.py; with a segment
               filter its convolutions too, swtbench/reference/classify.py),
               held to the float64 reference: the upper readings; with a
               filter also "tf32_conv", the float64 reference's own crops
               through TF32 convolutions, which moves nothing but the
               logits: the upper reading of logit_gap.

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
    from .reference.pipeline import classify_segments
    from .run import (cell_inputs, crop_rows, filter_weights, program_config,
                      program_results, segment_filter)
    from .source import StreamSource

    p, (H, W), corners, params, crop = cell_inputs(cell, shrink)
    T = int(p["window_size"])
    frames = frames - frames % (T * int(p["batch_windows"]))
    device = torch.device(device)
    weights = filter_weights(cell.config)
    for seed in seeds:
        clip = traffic.generate(params, seed, H, W, crop, keep_bgr=weights is not None)
        whole = None if weights is None else traffic.full_frames(clip)
        ref = run_reference(clip.first_frame, clip.crops, corners, p, frames, device,
                            frames=whole, weights=weights)
        if program:
            from swiftwatcher_tpu_torch.pipeline.runner import run_video

            B = int(p["batch_windows"])
            cfg = program_config(p)
            seg_filter = segment_filter(weights, cfg, device)
            with Probe(device, frames // (B * T) + 1, B, T,
                       crop_rows(cell.config, cfg) if seg_filter else 0) as probe:
                res = run_video(StreamSource(clip, frames, whole), corners, cfg, device,
                                tracker_impl=cell.config["tracker_impl"],
                                segment_filter=seg_filter)
            yield {"seed": seed, "side": "program",
                   "numbers": compare.numbers(program_results(res, probe, frames), ref)}
            del res, probe, seg_filter
        for precision in controls:
            ctl = run_reference(clip.first_frame, clip.crops, corners, p, frames, device,
                                precision=precision, frames=whole, weights=weights)
            yield {"seed": seed, "side": precision,
                   "numbers": compare.numbers(_over_stream(ctl, frames, T), ref)}
            if weights is not None and precision == "tf32":
                # the convolutions alone one step down, on the float64
                # reference's own crops: the upper reading of logit_gap
                conv, _ = classify_segments(whole, ref["boxes"], crop[0], p, device, weights,
                                            precision)
                same = _over_stream(dict(ref, logits=conv), frames, T)
                yield {"seed": seed, "side": "tf32_conv", "numbers": compare.numbers(same, ref)}


def _over_stream(result: dict, frames: int, T: int) -> dict:
    """A reference result, per window and frame of the clip, as the
    program's: per window and frame of the stream's first `frames` frames,
    logits per (frame, index) of a crop."""
    U, N = len(result["iters"]), len(result["segments"])
    out = dict(result, iters=[result["iters"][k % U] for k in range(frames // T)],
               segments=[result["segments"][fn % N] for fn in range(frames)])
    if result["shifts"] is not None:
        out["shifts"] = result["shifts"][[fn % N for fn in range(frames)]]
    if result["logits"] is not None:
        out["logits"] = {(fn, i): lg for fn in range(frames)
                         for i, lg in enumerate(result["logits"][fn % N]) if lg is not None}
    return out


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
