"""CLI flags, corner persistence and status output.

Counterpart of swiftwatcher_tpu/ui.py: the same flags, plus `--device`.
Corners come from <video dir>/<stem>/attributes.json; the interactive
pickers (the OpenCV corner window and the tkinter file dialog) are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Sequence, Tuple

# ROADMAP.md item of the interactive pickers.
_PICKERS_ITEM = "ROADMAP.md section 1 item 3, interactive pickers"


def parse_args(argv=None):
    """The JAX package's flags (the reference's six and its extensions),
    plus --device."""
    parser = argparse.ArgumentParser(prog="swiftwatcher-tpu-torch")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--filepaths", nargs="*", default=[])
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=-1)
    parser.add_argument("--classify", action="store_true",
                        help="drop the segments the SqueezeNet filter rejects "
                        "before tracking (the shipped weights)")
    parser.add_argument("--export", action="store_true",
                        help="write each segment's overlay and crop PNGs under "
                        "<video dir>/<stem>/segments, on either tracker")
    parser.add_argument(
        "--parallel-videos", type=int, default=1,
        help="process up to N videos concurrently; only 1 is ported "
        "(ROADMAP.md section 1 item 3)",
    )
    parser.add_argument(
        "--tracker", choices=["host", "device"], default="device",
        help="tracking implementation: device (the whole batch's tracking "
        "scan on the device, one kernel launch per batch on a card; the "
        "default, event-for-event equal to host on the test corpus) or "
        "host (scipy, the strict-parity reference path)",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="not ported yet (ROADMAP.md section 1 item 2)",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="DATAxMODEL",
        help="not ported yet (ROADMAP.md section 1 item 6)",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="FIELD=VALUE",
        help="override a PipelineConfig field (repeatable), e.g. "
        "--set rpca_warm_basis=false --set batch_windows=16",
    )
    parser.add_argument(
        "--accuracy-pack", action="store_true",
        help="the opt-in accuracy extensions as one preset "
        "(angle_band_halfwidth=60, false_angle_min_disp=5, "
        "stabilize_max_shift=3); stabilisation is not ported yet "
        "(ROADMAP.md section 1 item 5)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels)",
    )
    args = parser.parse_args(argv)
    args.filepaths = [Path(p).resolve() for p in args.filepaths]
    return args


def get_corners_from_file(filepath: Path) -> List[Tuple[int, int]]:
    """Load chimney corners from attributes.json (ui.py:180-194)."""
    with open(str(filepath)) as fh:
        attrs = json.load(fh)
    c = attrs["corners"]
    return [(int(c[0][0]), int(c[0][1])), (int(c[1][0]), int(c[1][1]))]


def save_corners_to_file(video_path: Path, corners: Sequence[Tuple[int, int]]) -> Path:
    """Persist corners next to the video (ui.py:197-208)."""
    base = video_path.parent / video_path.stem
    base.mkdir(parents=True, exist_ok=True)
    out = base / "attributes.json"
    with open(str(out), "w") as fh:
        json.dump({"corners": [list(c) for c in corners]}, fh)
    return out


def select_chimney_corners(video_path: Path) -> List[Tuple[int, int]]:
    """The interactive corner picker, not ported yet."""
    raise NotImplementedError(
        f"no {video_path.parent / video_path.stem / 'attributes.json'}, and the "
        f"interactive corner picker is not ported yet ({_PICKERS_ITEM}); write "
        '{"corners": [[x1, y1], [x2, y2]]} there'
    )


def select_filepaths() -> List[Path]:
    """The file dialog for an empty --filepaths, not ported yet."""
    raise NotImplementedError(
        f"no --filepaths given, and the file dialog is not ported yet ({_PICKERS_ITEM})"
    )


def start_status(video_name: str) -> None:
    sys.stdout.write("[*] Now processing {}.\n".format(video_name))


def frames_processed_status(frames_processed: int, total_frames: int) -> None:
    sys.stdout.write(
        "\r[-]     {0}/{1} frames processed.".format(frames_processed, total_frames)
    )
    sys.stdout.flush()
    if frames_processed >= total_frames:
        sys.stdout.write("\n")
