#!/usr/bin/env python
"""Build an HDF5 frame cache from any video file, through the PyTorch port.

Counterpart of tools/make_h5_cache.py, with the same arguments and
output: the video re-encoded into the container that the port's
io/source.py:HDF5Source reads (dataset "VideoFrames" of per-frame JPEG
buffers, attributes CAP_PROP_FPS and CAP_PROP_FRAME_COUNT), frames read by
the port's open_source.  A cache freezes the JPEG bytes, gives --start and
--end random access and checkpoint resume (a seekable source), and the
native JPEG decode path.  Needs h5py and cv2.  Imports no JAX and nothing
of the JAX package.

Usage: python tools/torch_make_h5_cache.py VIDEO [-o OUT.h5] [--quality 95]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from swiftwatcher_tpu_torch.io.source import open_source  # noqa: E402


def make_cache(video_path: Path, out_path: Path, quality: int = 95, status=True) -> int:
    import cv2
    import h5py
    import numpy as np

    source = open_source(video_path)
    n = source.total_frames
    dt = h5py.vlen_dtype(np.uint8)
    with h5py.File(str(out_path), "w") as fh:
        dset = fh.create_dataset("VideoFrames", (n,), dtype=dt)
        fh.attrs["CAP_PROP_FPS"] = float(source.fps)
        fh.attrs["CAP_PROP_FRAME_COUNT"] = int(n)
        written = 0
        for i in range(n):
            frame = source.read_frame(i)
            if frame is None:
                continue  # a decode error: the slot stays empty, and
                #           HDF5Source substitutes the last good frame
            ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
            if not ok:
                continue
            dset[i] = np.frombuffer(buf.tobytes(), np.uint8)
            written += 1
            if status and (i % 250 == 0 or i == n - 1):
                print(f"\r[-]     {i + 1}/{n} frames cached.", end="")
    if status:
        print()
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("video", type=Path)
    ap.add_argument("-o", "--out", type=Path, default=None)
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args(argv)
    out = args.out or args.video.with_suffix(".h5")
    n = make_cache(args.video, out, quality=args.quality)
    print(f"[-]     wrote {n} frames to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
