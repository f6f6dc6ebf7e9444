#!/usr/bin/env python
"""The accuracy corpus, scored through the PyTorch port.

Counterpart of tools/accuracy_corpus.py for swiftwatcher_tpu_torch: the
same hard synthetic scenes (crowding, occlusion, sensor noise, camera
jitter, near-ROI flybys, motion blur, exposure flicker, H.264 containers)
with constructed ground truth, run through the port's `run_video` and
scored by tools/torch_evaluate.py (tools/evaluate.py's method: TP =
min(predicted, actual) per time bin, FP and misses the excess either
way), detection-only (predicted + rejected events) and
detection+classification (predicted only).  It imports no JAX and
nothing of the JAX package: the scene table and the ground-truth writer
are copies kept here (tests/test_torch_host.py holds them and the
scoring to the originals).

    python tools/torch_accuracy_corpus.py [--scenes clean crowded ...]
        [--device cpu] [--granularity second] [--json out.json | --json -]
        [--no-variants]

Runs on the card unless --device says otherwise.  The container scenes
(h264_crowded, h264_blur, vfr_capture) need an H.264 writer (the port's
libav backend, io/native_av.py); where there is none they are listed as
not run, by name, and never replaced by another scene.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import require_cuda  # noqa: E402
from swiftwatcher_tpu_torch.io.export import frame_timestamp  # noqa: E402
from swiftwatcher_tpu_torch.io.source import ArraySource, VideoFileSource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_hard_video  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.runner import run_video  # noqa: E402
from torch_evaluate import (  # noqa: E402
    GT_COLUMNS,
    Score,
    _count_series,
    _fmt_row,
    load_groundtruth,
    load_results,
    score_counts,
)

# tools/accuracy_corpus.py's scene table, geometry and variants.
BASE = dict(n_frames=84, H=240, W=320, fps=30.0)

VARIANTS = {
    "stabilize3": dict(
        overrides={"stabilize_max_shift": 3},
        scenes=("clean", "noise11", "jitter1", "jitter2"),
        why="electronic stabilization (ops/stabilize.py); targets jitter*",
    ),
    "wide_angle_band": dict(
        overrides={"angle_band_halfwidth": 60.0},
        scenes=("clean", "crowded", "crowded_flyby", "occluded_crowd", "flyby_trap"),
        why="entry-angle band 30->60 deg: crowded lanes converge at shallow "
            "angles the reference's +-30 band rejects; flyby_trap controls "
            "that the wider band still rejects the vanish distractor",
    ),
    "false_angle_disp_gate": dict(
        overrides={"false_angle_min_disp": 5.0},
        scenes=("clean", "crowded", "occluded_crowd", "flyby_trap", "jitter1"),
        why="only drop multiple-of-15-deg angles when the path moved <5 px: "
            "the reference's grid-artifact heuristic miscounts real dives "
            "at exactly -90/-135 deg (crowded lanes); jitter1/flyby_trap "
            "control that true artifacts/distractors still drop",
    ),
    "accuracy_pack": dict(
        overrides={"angle_band_halfwidth": 60.0,
                   "false_angle_min_disp": 5.0,
                   "stabilize_max_shift": 3},
        scenes=tuple(),  # every scene, filled in below
        why="all opt-in accuracy extensions together (wide band + disp "
            "gate + stabilization): the 'beats the reference' headline and "
            "a check that the extensions do not interact destructively",
    ),
}

SCENES = {
    "clean":          dict(seed=40, n_entering=3, n_crossing=1),
    "crowded":        dict(seed=41, n_entering=5, simultaneous=True),
    "crowded_flyby":  dict(seed=42, n_entering=4, n_flyby=2, simultaneous=True),
    "occlusion":      dict(seed=43, n_entering=3, occluder=True),
    "occluded_crowd": dict(seed=44, n_entering=4, simultaneous=True, occluder=True),
    "noise5":         dict(seed=45, n_entering=3, noise=5, amp=90),
    "noise8":         dict(seed=46, n_entering=3, noise=8, amp=80),
    "noise11":        dict(seed=47, n_entering=3, noise=11, amp=70),
    "jitter1":        dict(seed=48, n_entering=3, jitter=1),
    "jitter2":        dict(seed=49, n_entering=3, jitter=2),
    "flyby_trap":     dict(seed=50, n_entering=2, n_flyby=3, n_vanishing=1),
    "drift":          dict(seed=51, n_entering=3, brightness_drift=0.4),
    "blur_shutter":   dict(seed=52, n_entering=3, motion_blur=0.5),
    "blur_fast":      dict(seed=53, n_entering=3, motion_blur=0.85, amp=130),
    "flicker_agc":    dict(seed=54, n_entering=3, flicker=0.05),
    # routed through an H.264 container: blocking artifacts, variable timing
    "h264_crowded":   dict(seed=55, n_entering=4, simultaneous=True, recompress=True),
    "h264_blur":      dict(seed=56, n_entering=3, motion_blur=0.5, recompress=True),
    "vfr_capture":    dict(seed=57, n_entering=3, vfr=True),
}

VARIANTS["accuracy_pack"]["scenes"] = tuple(SCENES)

NO_WRITER = "no H.264 writer"


def groundtruth_csv(video, path: Path, fps: float = None) -> None:
    """One row per true chimney entry, in the results CSV's columns.  fps
    overrides the clip's nominal rate for a container scene, whose events
    are stamped by the container's (average) rate."""
    import pandas as pd

    rows = [{"timestamp": frame_timestamp(fn, fps if fps else video.fps),
             "framenumber": fn, "predicted": 1} for fn in video.entry_frames]
    pd.DataFrame(rows, columns=["timestamp", "framenumber", "predicted"]).to_csv(
        path, index=False)


def run_scene(name: str, spec: dict, workdir: Path, granularity: str, device: torch.device,
              overrides: dict = None):
    """Run one scene through run_video on `device` and score its CSVs; None
    for a container scene where no H.264 writer is built."""
    from swiftwatcher_tpu_torch.io import native_av

    cfg = dataclasses.replace(DEFAULT_CONFIG, **overrides) if overrides else DEFAULT_CONFIG
    workdir.mkdir(parents=True, exist_ok=True)
    spec = dict(spec)
    recompress = spec.pop("recompress", False)
    vfr = spec.pop("vfr", False)
    video = make_hard_video(**BASE, **spec)
    gt_fps = video.fps
    if recompress or vfr:
        p = workdir / f"{name}.mp4"
        if vfr:
            # frame durations around the nominal rate; the pipeline sees
            # only the container's average rate
            rng = np.random.default_rng(spec.get("seed", 0) + 777)
            durs = rng.uniform(1.0 / (video.fps * 1.25), 1.0 / (video.fps * 0.8),
                               len(video.frames))
            pts = np.concatenate([[0.0], np.cumsum(durs[:-1])])
            ok = native_av.write_test_video_vfr(p, video.frames, pts)
        else:
            ok = native_av.write_test_video(p, video.frames, fps=video.fps)
        if not ok:
            return None
        source = VideoFileSource(p)
        gt_fps = source.fps
    else:
        source = ArraySource(video.frames, fps=video.fps)
    out = workdir / name
    try:
        result = run_video(source, video.corners, cfg, device, export_dir=out)
    finally:
        source.close()
    gt_path = workdir / f"{name}_gt.csv"
    groundtruth_csv(video, gt_path, fps=gt_fps)
    actual = _count_series(load_groundtruth(gt_path), GT_COLUMNS, granularity)
    scores = {}
    for kind, cols in (("detection", ("predicted", "rejected")),
                       ("detection+classification", ("predicted",))):
        try:
            pred = _count_series(load_results(out), cols, granularity)
        except FileNotFoundError:
            import pandas as pd

            pred = pd.Series(dtype=float)  # no events: every entry missed
        scores[kind] = score_counts(pred, actual)
    return {"video": video, "scores": scores, "events": len(result.events),
            "event_frames": [e.frame_number for e in result.events],
            "predicted": result.total_predicted, "rejected": result.total_rejected}


def _score_dict(s: Score) -> dict:
    return dict(tp=s.tp, fp=s.fp, missed=s.missed, precision=round(s.precision, 4),
                recall=round(s.recall, 4), f1=round(s.f1, 4))


def score_corpus(names, device: torch.device, granularity: str = "second",
                 variants: bool = True):
    """Score `names` (and, with `variants`, the opt-in variants on those of
    their scenes that ran) with run_video's host tracker, as
    tools/accuracy_corpus.py does: (the JSON object main prints, the
    scored rows)."""
    out = {"granularity": granularity, "corpus": "synthetic-hard-v1", "device": str(device),
           "scenes": {}, "not_run": {}}
    rows = []
    with tempfile.TemporaryDirectory() as td:
        for name in names:
            r = run_scene(name, SCENES[name], Path(td), granularity, device)
            if r is None:
                out["not_run"][name] = NO_WRITER
                print(f"[{name}] not run: {NO_WRITER}", file=sys.stderr)
                continue
            v = r["video"]
            out["scenes"][name] = {
                "gt_entries": len(v.entry_frames), "distractors": v.n_distractors,
                "events_detected": r["events"], "event_frames": r["event_frames"],
                "predicted": r["predicted"], "rejected": r["rejected"],
                **{kind: _score_dict(s) for kind, s in r["scores"].items()},
            }
            rows.append((name, r["scores"]))
            print(f"[{name}] gt={len(v.entry_frames)} detected={r['events']} "
                  f"pred={r['predicted']} rej={r['rejected']}", file=sys.stderr)
    for kind in ("detection", "detection+classification"):
        if not rows:
            break
        agg = Score(tp=sum(s[kind].tp for _, s in rows), fp=sum(s[kind].fp for _, s in rows),
                    missed=sum(s[kind].missed for _, s in rows))
        out.setdefault("AVG", {})[kind] = {
            "precision": round(float(np.mean([s[kind].precision for _, s in rows])), 4),
            "recall": round(float(np.mean([s[kind].recall for _, s in rows])), 4),
            "f1": round(float(np.mean([s[kind].f1 for _, s in rows])), 4),
            "pooled_f1": round(agg.f1, 4),
        }
    if variants:
        for vname, v in VARIANTS.items():
            vscenes = [n for n in v["scenes"] if n in out["scenes"]]
            if not vscenes:
                continue
            vout = {}
            with tempfile.TemporaryDirectory() as td:
                for name in vscenes:
                    r = run_scene(name, SCENES[name], Path(td), granularity, device,
                                  overrides=v["overrides"])
                    vout[name] = {kind: _score_dict(s) for kind, s in r["scores"].items()}
            out.setdefault("opt_in", {})[vname] = {
                "overrides": v["overrides"], "why": v["why"], "scenes": vout,
                "AVG": {kind: {
                    "f1": round(float(np.mean([vout[n][kind]["f1"] for n in vscenes])), 4),
                    "base_f1": round(float(np.mean(
                        [out["scenes"][n][kind]["f1"] for n in vscenes])), 4)}
                    for kind in ("detection", "detection+classification")},
            }
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", nargs="*", default=None, help="scene names (default: all)")
    ap.add_argument("--granularity", default="second",
                    choices=("exact", "second", "minute", "video"))
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--no-variants", action="store_true", help="skip the opt-in variants")
    ap.add_argument("--json", default=None, help="output path ('-' for stdout)")
    args = ap.parse_args(argv)
    names = args.scenes or list(SCENES)
    unknown = [n for n in names if n not in SCENES]
    if unknown:
        ap.error(f"unknown scenes {unknown}; have {list(SCENES)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = require_cuda()
    out, rows = score_corpus(names, device, args.granularity, variants=not args.no_variants)
    for kind in ("detection", "detection+classification"):
        print(f"\n== {kind} (granularity: {args.granularity}) ==", file=sys.stderr)
        print(f"{'scene':<28} {'actual':>6} {'predicted':>9} {'TP':>6} {'FP':>6} "
              f"{'missed':>6}  {'precision':>9} {'recall':>7} {'F1':>7}", file=sys.stderr)
        for name, scores in rows:
            print(_fmt_row(name, scores[kind]), file=sys.stderr)
    for name, why in out["not_run"].items():
        print(f"{name:<28} not run: {why}", file=sys.stderr)
    blob = json.dumps(out, indent=2)
    if args.json == "-":
        print(blob)
    elif args.json:
        Path(args.json).write_text(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
