#!/usr/bin/env python
"""Host decode budget of the port: the codec's floor against the
conversion's cost.

Counterpart of tools/decode_floor.py for swiftwatcher_tpu_torch.  Is the
port's host decode rate libavcodec's decode proper (then it is the floor)
or conversion and copying (then it can be shaved)?  Interleaved passes in
one process over one H.264 encode of the bench scene (written by the
port's io/native_av.py:write_test_video), each mode's best rate kept:

  null       decode only, the frame dropped (AVReader.read_null): the
             codec floor, which no conversion tuning can beat
  gray_crop  decode and the chroma-aligned gray conversion of the chimney
             crop (AVReader.read_gray_crop, the gray-crop ingest path)
  full_bgr   decode and the whole frame's BGR conversion (AVReader.read)
  cv2        cv2.VideoCapture's full decode, through the port's
             VideoFileSource(backend="cv2") (the reference's own reader)

    python tools/torch_decode_floor.py [--frames 315] [--passes 3] [--file X]
        [--device cpu]

Prints one JSON line.  Exits 2, with a JSON error line, where the port's
libav library is not built on this host ("native av lib unavailable"),
where it has no H.264 encoder ("no H.264 encoder"), or where the library
lacks swt_av_read_null.  The decode runs on the host whatever the device;
--device (default: the card) names the machine the run stands for, and
raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import card_line, device_from_arg  # noqa: E402
from swiftwatcher_tpu_torch.geometry import crop_region_from_corners  # noqa: E402
from swiftwatcher_tpu_torch.io import native_av  # noqa: E402
from swiftwatcher_tpu_torch.io.source import VideoFileSource  # noqa: E402
from swiftwatcher_tpu_torch.io.synthetic import make_video  # noqa: E402

MODES = ("null", "gray_crop", "full_bgr", "cv2")


def _rate(path, mode: str, crop) -> tuple:
    """(frames/s, frames) of one pass of `mode` over the file."""
    if mode == "cv2":
        src = VideoFileSource(path, backend="cv2")
        step = lambda k: src.read_frame(k) is not None  # noqa: E731
    else:
        src = native_av.AVReader.open(path)
        step = {
            "null": lambda k: src.read_null(),
            "gray_crop": lambda k: src.read_gray_crop(crop) is not None,
            "full_bgr": lambda k: src.read() is not None,
        }[mode]
    try:
        t0 = time.perf_counter()
        k = 0
        while step(k):
            k += 1
        dt = time.perf_counter() - t0
    finally:
        src.close()
    return k / dt, k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=315)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--file", default=None,
                    help="existing video file (default: encode the bench scene fresh)")
    ap.add_argument("--device", default="cuda",
                    help="the machine the run stands for (default: the card)")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)

    if not native_av.is_available():
        print(json.dumps({"error": "native av lib unavailable"}))
        return 2
    video = make_video(seed=0, n_frames=63, H=1080, W=1920,
                       n_entering=2, n_crossing=1, n_vanishing=1)
    crop = crop_region_from_corners(video.corners, DEFAULT_CONFIG)

    with tempfile.TemporaryDirectory() as td:
        if args.file:
            p = args.file
        else:
            loops = max(args.frames // 63, 1)
            tiled = np.tile(video.frames, (loops, 1, 1, 1))
            p = os.path.join(td, "floor.mp4")
            if not native_av.write_test_video(p, tiled, fps=video.fps):
                print(json.dumps({"error": "no H.264 encoder"}))
                return 2

        rd = native_av.AVReader.open(p)
        if rd is None:
            print(json.dumps({"error": "native av lib unavailable"}))
            return 2
        has_null = rd.read_null()
        rd.close()
        if not has_null:
            print(json.dumps({"error": "lib lacks swt_av_read_null (stale build?)"}))
            return 2

        best = {}
        n_seen = None
        for _ in range(args.passes):          # interleaved, so drift hits every mode
            for mode in MODES:
                fps, k = _rate(p, mode, crop)
                if mode != "cv2":
                    n_seen = k
                best[mode] = max(best.get(mode, 0.0), fps)

    conv_share = 1.0 - best["gray_crop"] / best["null"]
    out = {
        "frames": n_seen,
        "passes": args.passes,
        "fps": {k: round(v, 1) for k, v in best.items()},
        "gray_crop_conversion_share": round(conv_share, 3),
        "finding": (
            "gray-crop is within {:.0%} of the null-decode codec floor — "
            "the remaining ingest budget is libavcodec itself; no "
            "conversion tuning can recover it".format(max(conv_share, 0.0))
            if conv_share < 0.15
            else "conversion/copy costs {:.0%} on top of the codec floor "
            "— worth shaving".format(conv_share)
        ),
        "host_cores": os.cpu_count(),
        "card": card_line(device),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
