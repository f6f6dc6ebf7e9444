"""Console entry point of the port.

    python -m swiftwatcher_tpu_torch --filepaths night.mp4 [clip.npy cache.h5 ...]
        [--classify] [--export] [--profile] [--parallel-videos N]
        [--accuracy-pack] [--mesh DATAxMODEL] [--set field=value ...]
        [--device cpu]

Counterpart of swiftwatcher_tpu/__main__.py (reference __main__.py:13-53):
per video, open a frame source by suffix (io/source.py: a container
through the fastest decode backend that engages on it, an HDF5 file, a
.npy clip), read the chimney corners from <video dir>/<stem>/
attributes.json (or pick them in a window), count on the device, and
write the six PREDICTED/REJECTED CSVs next to the video (under --debug,
into a versioned run directory).  --classify filters segments with the
shipped SqueezeNet weights (models/segment_classifier.npz); --export
writes each segment's PNGs under <video dir>/<stem>/segments; --profile
writes a profiler trace and the run manifest under <video dir>/<stem>/
profile; --parallel-videos N counts up to N videos at once (without the
progress line); --mesh DATAxMODEL shards each batch's localisation over
that many ranks (parallel/mesh.py: one card each on NCCL, or processes
sharing the card or the CPU on gloo).  With no --filepaths a file dialog
asks for them.  Runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import re
import sys

import torch

from . import ui
from .config import ACCURACY_PACK_OVERRIDES, config_with_overrides
from .device import require_cuda
from .io.source import open_source
from .parallel.mesh import make_mesh
from .pipeline.multi import run_videos
from .pipeline.runner import run_video


def main(argv=None) -> int:
    args = ui.parse_args(argv)
    overrides = list(args.set)
    if args.accuracy_pack:
        # preset first: an explicit --set of the same field wins
        overrides = list(ACCURACY_PACK_OVERRIDES) + overrides
    cfg = config_with_overrides(overrides)
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    mesh_shape = None
    if args.mesh:
        m = re.fullmatch(r"(\d+)(?:x(\d+))?", args.mesh)
        if not m:
            print(
                f"[!] --mesh must look like DATAxMODEL (e.g. 4x2), "
                f"got {args.mesh!r}.", file=sys.stderr,
            )
            return 2
        mesh_shape = (int(m.group(1)), int(m.group(2) or 1))
        if device.type == "cuda":
            have = torch.cuda.device_count()
            if mesh_shape[0] * mesh_shape[1] > have:
                print(
                    f"[!] --mesh {args.mesh} needs {mesh_shape[0] * mesh_shape[1]} "
                    f"devices; only {have} available.", file=sys.stderr,
                )
                return 2
    filepaths = args.filepaths if args.filepaths else ui.select_filepaths()
    segment_filter = None
    if args.classify:
        from .models.classifier import SqueezeNetSegmentFilter

        segment_filter = SqueezeNetSegmentFilter.from_default_weights(cfg, device)

    jobs, out_dirs = [], []
    for src_path in filepaths:
        source = open_source(src_path, start=args.start, end=args.end if args.end > 0 else 0)
        output_dir = src_path.parent / src_path.stem
        attrs = output_dir / "attributes.json"
        if attrs.is_file():
            corners = ui.get_corners_from_file(attrs)
        else:
            corners = ui.select_chimney_corners(src_path)
        jobs.append((source, corners))
        out_dirs.append(output_dir)

    mesh = None

    def kwargs_for(i):
        return dict(
            export_dir=out_dirs[i],
            debug=args.debug,
            status_cb=ui.frames_processed_status if args.parallel_videos == 1 else None,
            segment_filter=segment_filter,
            # the sibling output directory, as the JAX package's CLI does
            export_segments_dir=(out_dirs[i] / "segments") if args.export else None,
            tracker_impl=args.tracker,
            profile_dir=(out_dirs[i] / "profile") if args.profile else None,
            mesh=mesh,
        )

    try:
        if mesh_shape is not None:
            mesh = make_mesh(mesh_shape, device=device)
            print(f"[-] mesh {mesh_shape[0]}x{mesh_shape[1]} on {mesh.backend}, rank 0 on "
                  f"{mesh.device}")
        if args.parallel_videos > 1:
            results = run_videos(jobs, cfg, device, max_concurrent=args.parallel_videos,
                                 per_video_kwargs=kwargs_for)
        else:
            results = []
            for i, (source, corners) in enumerate(jobs):
                ui.start_status(filepaths[i].name)
                results.append(run_video(source, corners, cfg, device, **kwargs_for(i)))
    finally:
        if mesh is not None:
            mesh.close()
        for source, _ in jobs:
            source.close()

    for src_path, result in zip(filepaths, results):
        if result.classified is None:
            print("[!] No events detected in video '{}'.".format(src_path.stem))
        else:
            print(
                "[-]     {}: {} predicted / {} rejected swifts.".format(
                    src_path.stem, result.total_predicted, result.total_rejected
                )
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
