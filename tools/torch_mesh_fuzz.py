"""Randomized mesh-geometry fuzz of the port: run_video(mesh=...) against
the unsharded run_video, event for event.

The port's counterpart of tools/mesh_fuzz.py: N scenes drawn from a
campaign seed (its scene generator, copied so that this tool imports
nothing of the JAX package), scene i on mesh shape MESH_SHAPES[i % 7] of
gloo ranks (processes) on the CPU, the device tracker, batch_windows 8.
A scene matches when the predicted/rejected totals and every event's
frame number and first/last centroids are equal.  The scenes of one shape
share one mesh (a mesh takes seconds to start).

Prints one JSON line per scene and a summary line with the mismatch count;
exits 1 on any mismatch.

    python tools/torch_mesh_fuzz.py --scenes 20 [--campaign-seed 20260820]
        [--out result.json]
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402

# (data, model) factorizations over <= 8 ranks; model shards the flat
# pixel axis (the odd width exercises the padding), data the windows
# (batch_windows 8 divides over every data axis here)
MESH_SHAPES = [(2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2), (2, 4)]
# one odd-width crop (the worst case for the padding), one even
GEOMS = [(240, 318), (250, 422)]
CPU = torch.device("cpu")


def scene_params(rng: np.random.Generator, idx: int) -> dict:
    """tools/mesh_fuzz.py:scene_params."""
    H, W = GEOMS[idx % len(GEOMS)]
    return dict(
        seed=int(rng.integers(0, 2**31 - 1)),
        n_frames=int(rng.choice([45, 63])),
        H=H,
        W=W,
        n_entering=int(rng.integers(0, 4)),
        n_crossing=int(rng.integers(0, 3)),
        n_vanishing=int(rng.integers(0, 3)),
        noise=int(rng.integers(2, 6)),
        dot=int(rng.choice([3, 4, 5])),
        brightness_drift=float(rng.choice([0.0, 0.0, 0.15])),
    )


def _events(res) -> dict:
    return dict(
        predicted=res.total_predicted,
        rejected=res.total_rejected,
        events=[(e.frame_number, list(e.first_centroid), list(e.last_centroid))
                for e in res.events],
    )


def run_campaign(scenes: int, campaign_seed: int = 20260820, out: str | None = None) -> dict:
    rng = np.random.default_rng(campaign_seed)
    cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=8)
    params = [scene_params(rng, i) for i in range(scenes)]
    results = []
    t_start = time.perf_counter()

    def summarize():
        return dict(
            scenes=len(results),
            scenes_requested=scenes,
            mismatches=sum(not r["ok"] for r in results),
            campaign_seed=campaign_seed,
            mesh_shapes=MESH_SHAPES,
            geometries=GEOMS,
            elapsed_s=round(time.perf_counter() - t_start, 1),
            note=("run_video(mesh=(data, model)) of gloo ranks on the CPU vs unsharded, "
                  "device tracker, batch_windows=8; equality on predicted/rejected totals "
                  "and (frame_number, first_centroid, last_centroid) per event"),
            results=sorted(results, key=lambda r: r["scene"]),
        )

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for shape in MESH_SHAPES:
            mine = [i for i in range(scenes) if MESH_SHAPES[i % len(MESH_SHAPES)] == shape]
            if not mine:
                continue
            with make_mesh(shape, device=CPU, timeout=300) as mesh:
                for i in mine:
                    video = make_video(**params[i])
                    runs = [_events(run_video(ArraySource(video.frames, fps=video.fps),
                                              video.corners, cfg, CPU, tracker_impl="device",
                                              mesh=m))
                            for m in (None, mesh)]
                    row = dict(scene=i, mesh=list(shape), ok=runs[0] == runs[1],
                               params=params[i], base=runs[0], sharded=runs[1])
                    print(json.dumps(row), flush=True)
                    results.append(row)
                    if out:  # rewritten after every scene
                        Path(out).write_text(json.dumps(summarize(), indent=1))
    finally:
        torch.set_num_threads(threads)

    summary = summarize()
    print(json.dumps({"summary": {k: v for k, v in summary.items() if k != "results"}}),
          flush=True)
    if out:
        Path(out).write_text(json.dumps(summary, indent=1))
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=20)
    ap.add_argument("--campaign-seed", type=int, default=20260820)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    summary = run_campaign(args.scenes, args.campaign_seed, args.out)
    sys.exit(1 if summary["mismatches"] else 0)


if __name__ == "__main__":
    main()
