#!/usr/bin/env python
"""Batch-save attributes.json corner files for videos, through the PyTorch port.

Counterpart of tools/export_corners.py (the rebuild of the reference's
research/scripts/export_corners_to_file.py), with the same arguments and
output: for each video, the port's interactive corner picker
(ui.select_chimney_corners), or --corners x1,y1,x2,y2 for headless use,
and <video dir>/<stem>/attributes.json written by ui.save_corners_to_file.
Imports no JAX and nothing of the JAX package.

Usage:
    python tools/torch_export_corners.py VIDEO...                 # interactive
    python tools/torch_export_corners.py VIDEO --corners 134,138,192,138
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from swiftwatcher_tpu_torch import ui  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("videos", nargs="+")
    ap.add_argument("--corners", default=None, help="x1,y1,x2,y2 (headless)")
    args = ap.parse_args(argv)

    for v in args.videos:
        path = Path(v)
        if args.corners:
            x1, y1, x2, y2 = (int(t) for t in args.corners.split(","))
            corners = [(x1, y1), (x2, y2)]
        else:
            corners = ui.select_chimney_corners(path)
        out = ui.save_corners_to_file(path, corners)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
