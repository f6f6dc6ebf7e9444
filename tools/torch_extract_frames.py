#!/usr/bin/env python
"""Dump video frames to a PNG tree for annotation, through the PyTorch port.

Counterpart of tools/extract_frames.py (the rebuild of the reference's
research/scripts/extract_frames.py), with the same arguments and output:
<out>/<stem>/frames/<first>-<last>/<stem>_<frame>.png, frames read by the
port's io/source.py:open_source.  Imports no JAX and nothing of the JAX
package.

Usage: python tools/torch_extract_frames.py VIDEO [--out DIR] [--start N] [--end N]
                                             [--group-size N]
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from swiftwatcher_tpu_torch.io.source import open_source  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("--out", default=None)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=1000)
    args = ap.parse_args(argv)

    import cv2

    src_path = Path(args.video)
    source = open_source(src_path, start=args.start, end=args.end)
    # --out replaces only the parent: the <stem>/frames subtree is always
    # kept, so annotation tooling finds the frames either way
    parent = Path(args.out) if args.out else src_path.parent
    out_base = parent / src_path.stem / "frames"

    n = skipped = 0
    while source.next_frame_number < source.end_frame:
        frame, num, _ = source.get_frame()
        if num < 0:
            break
        if frame is None:
            # a read error before any good frame: nothing to substitute
            skipped += 1
            continue
        group = (num // args.group_size) * args.group_size
        d = out_base / f"{group}-{group + args.group_size - 1}"
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{src_path.stem}_{num}.png"), frame)
        n += 1
    msg = f"wrote {n} frames under {out_base}"
    if skipped:
        msg += f" ({skipped} unreadable frames skipped)"
    print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
