#!/usr/bin/env python
"""Write every named stage of one window of a video as PNGs, through the
PyTorch port.

Counterpart of tools/dump_stages.py: the reference keeps each processing
stage of a frame in Frame.processed_frames for inspection; this runs one
window's chimney crop through pipeline/window.py:localize_window_debug and
writes, for each of its frames, <frame>_<stage>.png for the stages
grayscale, RPCA, bilateral, thresh_15, opened and cc_labeling (labels
spread over the gray range to be told apart).

    python tools/torch_dump_stages.py VIDEO [--window 0] [--out DIR] [--device cpu]

Corners come from <video dir>/<stem>/attributes.json (or a picker window);
the PNGs go to <video dir>/<stem>/stages unless --out says otherwise.  Runs
on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch import ui  # noqa: E402
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import pin_numerics, require_cuda  # noqa: E402
from swiftwatcher_tpu_torch.geometry import crop_array, crop_region_from_corners  # noqa: E402
from swiftwatcher_tpu_torch.io.source import open_source  # noqa: E402
from swiftwatcher_tpu_torch.pipeline.window import localize_window_debug  # noqa: E402


def dump_stages(video: Path, window: int, out: Path, device: torch.device, cfg=DEFAULT_CONFIG):
    """Write the stage PNGs of window `window` of `video` into `out`;
    returns (stage names, frame numbers, IALM iterations)."""
    import cv2

    attrs = video.parent / video.stem / "attributes.json"
    corners = (ui.get_corners_from_file(attrs) if attrs.is_file()
               else ui.select_chimney_corners(video))
    region = crop_region_from_corners(corners, cfg)
    source = open_source(video)
    try:
        for _ in range(window + 1):
            frames, numbers, _ = source.get_window(cfg.window_size)
    finally:
        source.close()
    crop = np.stack([crop_array(np.asarray(f), region) for f in frames])
    _, stages, iters = localize_window_debug(torch.from_numpy(crop).to(device), cfg)
    out.mkdir(parents=True, exist_ok=True)
    for name, plane in stages.items():
        plane = plane.cpu().numpy()
        if name == "cc_labeling":
            plane = (plane.astype(np.uint16) * 37 % 256).astype(np.uint8)
        for t in range(plane.shape[0]):
            cv2.imwrite(str(out / f"{numbers[t]}_{name}.png"), plane[t])
    return list(stages), list(numbers), int(iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("video", type=Path)
    ap.add_argument("--window", type=int, default=0, help="window index (21 frames each)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = require_cuda()
        pin_numerics()
    out = args.out or args.video.parent / args.video.stem / "stages"
    names, numbers, iters = dump_stages(args.video, args.window, out, device)
    print(f"wrote {len(names)} stages x {len(numbers)} frames to {out} "
          f"(IALM iterations: {iters})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
