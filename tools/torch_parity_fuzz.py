"""Randomized many-scene parity fuzz of the PyTorch port: host vs device
tracker, and both vs the reference-semantics oracle.

For N synthetic scenes drawn from a campaign seed (the scene generator of
tools/parity_fuzz.py, copied so that the port's side imports nothing of the
JAX package), run the port's `run_video` with the host tracker and with the
device tracker, and `tests/oracle_pipeline.reference_pipeline` on the same
frames.  A scene matches when

  * host and device give the same predicted/rejected totals, the same
    event frame numbers and stamps in order, and centroids within 1e-3
    (the device tracker keeps f32 centroids, the host tracker f64);
  * each gives the oracle's totals and sorted event frame numbers.

Prints one JSON line per scene and a summary line with the mismatch count;
exits 1 on any mismatch.

    python tools/torch_parity_fuzz.py --scenes 40 [--campaign-seed 20260820]
        [--device cpu] [--out result.json] [--set field=value ...]

--set overrides the port's config for both trackers (e.g. wire_codec=delta6
ships every batch through the wire codec); the oracle has no such fields.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import config_with_overrides  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402

from oracle_pipeline import reference_pipeline  # noqa: E402


def scene_params(rng: np.random.Generator, idx: int) -> dict:
    """tools/parity_fuzz.py:scene_params: three pinned geometries, random
    actors, noise, blob size and brightness drift."""
    H, W = [(240, 320), (200, 420), (288, 352)][idx % 3]
    return dict(
        seed=int(rng.integers(0, 2**31 - 1)),
        n_frames=int(rng.choice([45, 63, 84])),
        H=H,
        W=W,
        n_entering=int(rng.integers(0, 4)),
        n_crossing=int(rng.integers(0, 3)),
        n_vanishing=int(rng.integers(0, 3)),
        noise=int(rng.integers(2, 6)),
        dot=int(rng.choice([3, 4, 5])),
        brightness_drift=float(rng.choice([0.0, 0.0, 0.15])),
    )


def _counts(res) -> dict:
    return dict(predicted=res.total_predicted, rejected=res.total_rejected,
                fns=sorted(e.frame_number for e in res.events))


def _trackers_agree(host, dev) -> bool:
    if _counts(host) != _counts(dev) or len(host.events) != len(dev.events):
        return False
    for h, d in zip(host.events, dev.events):
        if (h.frame_number, h.timestamp) != (d.frame_number, d.timestamp):
            return False
        if not np.allclose(h.first_centroid + h.last_centroid,
                           d.first_centroid + d.last_centroid, atol=1e-3):
            return False
    return True


def run_campaign(scenes: int, campaign_seed: int, device: torch.device,
                 out: str | None = None, overrides=()) -> dict:
    cfg = config_with_overrides(list(overrides))
    rng = np.random.default_rng(campaign_seed)
    rows, mismatches, t_start = [], 0, time.perf_counter()
    for i in range(scenes):
        params = scene_params(rng, i)
        video = make_video(**params)
        res = {impl: run_video(ArraySource(video.frames, fps=video.fps), video.corners,
                               cfg, device, tracker_impl=impl)
               for impl in ("host", "device")}
        events_o, labels_o = reference_pipeline(video.frames, video.corners, video.fps)
        oracle = dict(predicted=int(sum(labels_o)),
                      rejected=int(len(labels_o) - sum(labels_o)),
                      fns=sorted(fn for _, _, fn in events_o))
        row = dict(scene=i, params=params, host=_counts(res["host"]),
                   device=_counts(res["device"]), oracle=oracle,
                   trackers_agree=_trackers_agree(res["host"], res["device"]),
                   track_overflows=res["device"].metrics.track_overflows)
        row["ok"] = row["trackers_agree"] and row["host"] == oracle == row["device"]
        mismatches += not row["ok"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(scenes=scenes, mismatches=mismatches, campaign_seed=campaign_seed,
                   device=str(device), overrides=list(overrides),
                   elapsed_s=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"summary": summary}), flush=True)
    if out:
        Path(out).write_text(json.dumps(dict(summary, results=rows), indent=1))
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--campaign-seed", type=int, default=20260820)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    args = ap.parse_args()
    summary = run_campaign(args.scenes, args.campaign_seed, torch.device(args.device), args.out,
                           args.set)
    sys.exit(1 if summary["mismatches"] else 0)


if __name__ == "__main__":
    main()
