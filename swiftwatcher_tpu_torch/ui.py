"""CLI flags, corner persistence and status output.

Counterpart of swiftwatcher_tpu/ui.py: the same flags, plus `--device`.
Corners come from <video dir>/<stem>/attributes.json when it exists,
else from the OpenCV click window; an empty --filepaths
opens the tkinter file dialog.  Without a display either picker exits
with a message saying what to do instead, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Sequence, Tuple

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
        help="process up to N videos concurrently (default 1 = sequential, "
        "matching the reference; no progress line above 1)",
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
        help="write a torch.profiler trace (trace.json) and the run manifest "
        "with per-stage device times into <video dir>/<stem>/profile "
        "(serializes the pipeline while on)",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="DATAxMODEL",
        help="run localization over a device mesh, e.g. --mesh 4x2 = "
        "windows data-parallel over 4 device groups, RPCA pixels "
        "sequence-parallel over 2 (requires that many devices; "
        "batch_windows must divide the data axis); on --device cpu the "
        "ranks are processes and any shape works",
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
        "stabilize_max_shift=3), equal to those three --set overrides; an "
        "explicit --set still wins.  Off = exact reference parity.",
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
    """The interactive OpenCV corner picker (ui.py:107-177): click the two
    corners, then y to keep them or n to pick again.  Exits with a message
    where no display is available."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    ok, image = cap.read()
    cap.release()   # only the first frame is needed; don't hold the handle
    if not ok:
        sys.stderr.write("[!] Error: could not read first frame for corner picking.\n")
        sys.exit(1)

    corners: List[Tuple[int, int]] = []

    def on_click(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN and len(corners) < 2:
            corners.append((int(x), int(y)))
            cv2.circle(image, corners[-1], 5, (0, 0, 255), -1)
            cv2.imshow("image", image)

    clone = image.copy()
    # headless detection: only window CREATION means "no display" — a
    # cv2.error once the window is open is a closed window, not a missing
    # display, and must not be misreported as one
    try:
        cv2.namedWindow("image", cv2.WINDOW_NORMAL)
        cv2.setMouseCallback("image", on_click)
        cv2.setWindowTitle("image", "Click on corner 1, then corner 2; y=keep n=retry")
        cv2.imshow("image", image)
    except cv2.error:
        sys.stderr.write(
            "[!] Error: no display available for interactive corner selection.\n"
            "    Create <video dir>/<stem>/attributes.json with "
            '{"corners": [[x1, y1], [x2, y2]]} instead.\n'
        )
        sys.exit(1)
    try:
        while True:
            cv2.imshow("image", image)
            cv2.waitKey(1)
            if len(corners) == 2:
                key = cv2.waitKey(2000) & 0xFF
                if chr(key).lower() == "n":
                    image = clone.copy()
                    corners.clear()
                elif chr(key).lower() == "y":
                    break
            if cv2.getWindowProperty("image", cv2.WND_PROP_VISIBLE) == 0:
                sys.stderr.write("[!] Error: window closed without selecting corners.\n")
                sys.exit(1)
        cv2.destroyAllWindows()
        return corners
    except cv2.error:
        sys.stderr.write("[!] Error: window closed during corner selection.\n")
        sys.exit(1)


def select_filepaths() -> List[Path]:
    """The tkinter multi-select dialog for an empty --filepaths
    (ui.py:45-99).  Exits with a message where tkinter or a display is
    missing."""
    try:
        import tkinter as tk
        from tkinter import filedialog
    except ImportError:
        sys.stderr.write("[!] Error: no --filepaths given and tkinter unavailable.\n")
        sys.exit(1)
    root = tk.Tk()
    root.withdraw()
    files = filedialog.askopenfilenames(parent=root, title="Choose the files to analyse.")
    paths = [Path(f) for f in root.tk.splitlist(files)]
    if not paths:
        sys.stderr.write("[!] Error: No file selected.\n")
        sys.exit(1)
    prompt_additional_selection(paths)
    return paths


def prompt_additional_selection(file_list: Sequence[Path]) -> bool:
    """The reference's "select more files?" confirm prompt (ui.py:81-99):
    lists the chosen files, asks for more.

    In the reference the answer is compared with `is "y"` — identity against
    a fresh, lowercased input() string — so it is ALWAYS false and the
    selection loop exits after one pass regardless of the reply.  That
    effective behavior (prompt shown, answer ignored) is reproduced here
    deliberately; returning True would be a parity deviation, not a fix."""
    print("[*] Video files to be analysed: ")
    print(*["[-]     {}".format(f.name) for f in file_list], sep="\n")
    try:
        input(
            "[*] Are there additional files you would like to "
            "select? (Y/N) \n"
            "[-]     Input: "
        )
    except EOFError:
        pass
    return False


def start_status(video_name: str) -> None:
    sys.stdout.write("[*] Now processing {}.\n".format(video_name))


def frames_processed_status(frames_processed: int, total_frames: int) -> None:
    sys.stdout.write(
        "\r[-]     {0}/{1} frames processed.".format(frames_processed, total_frames)
    )
    sys.stdout.flush()
    if frames_processed >= total_frames:
        sys.stdout.write("\n")
