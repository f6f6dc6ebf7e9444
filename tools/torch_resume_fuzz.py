"""Randomized checkpoint/resume fuzz of the PyTorch port: a run that is
cut and resumed equals the run that was not.

The port's copy of tools/resume_fuzz.py.  What breaks checkpointing is
where the cut lands against window and batch boundaries, so for N scenes
drawn from a campaign seed (tools/torch_parity_fuzz.py's generator):

  * a random scene, tracker (host and device in turn), batch_windows in
    {1, 2}, and on every third scene a deterministic segment filter (keep
    the segments of even area; on the host tracker, whose per-frame
    filters see the region tables);
  * a full run; then a run cut at a random frame (the source ends there)
    with checkpoint_interval_batches=1, so that its last batch writes a
    checkpoint; then a run over the whole source that resumes from it;

and checks that the resumed run's predicted/rejected totals and sorted
event frame numbers equal the full run's.  Prints one JSON line per scene
and a summary line; exits 1 on any mismatch.

    python tools/torch_resume_fuzz.py --scenes 20 [--campaign-seed 20260820]
        [--device cpu] [--out result.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402

from torch_parity_fuzz import _counts, scene_params  # noqa: E402


class EvenRejector:
    """Keep the segments whose area is even: a filter that is the same on
    every run, to carry the filter's path through a checkpoint."""

    def __call__(self, table, bt, frame, crop_region):
        b, t = bt
        areas = np.asarray(table.area[b, t])
        return [bool(areas[k] % 2 == 0) for k in np.nonzero(np.asarray(table.valid[b, t]))[0]]


def run_campaign(scenes: int, campaign_seed: int = 20260820, device: str = "cpu",
                 out: str | None = None) -> dict:
    rng = np.random.default_rng(campaign_seed)
    dev = torch.device(device)
    results = []
    t_start = time.perf_counter()

    def summarize():
        return dict(scenes=len(results), mismatches=sum(not r["ok"] for r in results),
                    campaign_seed=campaign_seed, device=str(dev),
                    elapsed_s=round(time.perf_counter() - t_start, 1), results=results)

    for i in range(scenes):
        params = scene_params(rng, i)
        filt = EvenRejector() if i % 3 == 2 else None
        # the filter reads the region tables, which the host tracker hands it
        tracker = "device" if i % 2 == 0 and filt is None else "host"
        cut = int(rng.integers(1, params["n_frames"]))
        cfg = dataclasses.replace(DEFAULT_CONFIG, batch_windows=1 + (i // 2) % 2)
        video = make_video(**params)
        kw = dict(tracker_impl=tracker, segment_filter=filt)

        def source():
            return ArraySource(video.frames, fps=video.fps)

        full = run_video(source(), video.corners, cfg, dev, **kw)
        with tempfile.TemporaryDirectory() as td:
            ck = Path(td) / "fuzz.ckpt"
            partial = source()
            partial.total_frames = cut
            run_video(partial, video.corners, cfg, dev, checkpoint_path=ck,
                      checkpoint_interval_batches=1, **kw)
            wrote_ck = ck.exists()
            resumed = run_video(source(), video.corners, cfg, dev, checkpoint_path=ck, **kw)
        f, r = _counts(full), _counts(resumed)
        row = dict(scene=i, tracker=tracker, batch_windows=cfg.batch_windows,
                   filtered=filt is not None, cut_frame=cut, checkpoint_written=wrote_ck,
                   ok=f == r and wrote_ck, params=params, full=f, resumed=r)
        print(json.dumps(row), flush=True)
        results.append(row)
        if out:  # rewritten after every scene
            Path(out).write_text(json.dumps(summarize(), indent=1))

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
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    summary = run_campaign(args.scenes, args.campaign_seed, args.device, args.out)
    sys.exit(1 if summary["mismatches"] else 0)


if __name__ == "__main__":
    main()
