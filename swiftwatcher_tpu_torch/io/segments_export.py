"""--export: per-segment overlay and crop PNGs.

Counterpart of swiftwatcher_tpu/io/segments_export.py, after the
reference's Frame.export_segments (data_structures.py:65-113): for every
segment of a processed frame, write
  * an overlay PNG of the chimney crop with the segment's bbox filled red
    at alpha 0.6, under <export_dir>/overlay/;
  * the segment's crop (expanded to at least 24x24) from the
    FULL-resolution frame, under <export_dir>/;
both named '"<src>"_<frame>_<label>_<nsegs>.png'.  cv2 is imported inside
the function, so the port imports without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..models.classifier import expand_bbox


def export_frame_segments(
    frame_bgr: np.ndarray,
    table,
    index,
    frame_number: int,
    crop_region,
    export_dir: Path,
    src_name: str,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    keep=None,
) -> int:
    """Write the overlay and crop PNGs of one frame's segments of a host
    table; returns how many segments were written.

    keep: optional classifier keep-mask over the frame's valid segments in
    ascending label order.  The reference filters before it exports
    (__main__.py:84-96) and relabels the survivors 1..N
    (segment_classification.py:40-44), so a rejected segment writes no PNG
    and names carry the post-filter labels and count."""
    import cv2

    export_dir = Path(export_dir)
    # the reference makes the directories for every exported frame, with or
    # without segments (data_structures.py:65-67)
    (export_dir / "overlay").mkdir(parents=True, exist_ok=True)

    if isinstance(index, tuple):
        def get(a):
            return np.asarray(a[index[0], index[1]])
    else:
        def get(a):
            return np.asarray(a[index])
    ks = np.nonzero(get(table.valid))[0]
    if keep is not None:
        ks = [k for k, kp in zip(ks, keep) if kp]
    if len(ks) == 0:
        return 0

    (x1, y1), (x2, y2) = crop_region
    crop_img = frame_bgr[y1:y2, x1:x2]
    min_y, min_x = get(table.min_y), get(table.min_x)
    max_y, max_x = get(table.max_y), get(table.max_x)

    n = len(ks)
    for i, k in enumerate(ks):
        # survivors are relabelled 1..N; unfiltered slots already carry the
        # contiguous labels 1..N (slot index == CCL label)
        label = i + 1 if keep is not None else int(k)
        name = '"{}"_{}_{}_{}.png'.format(src_name, frame_number, label, n)
        bbox = (int(min_y[k]), int(min_x[k]), int(max_y[k]), int(max_x[k]))

        # overlay: alpha-blended filled rectangle (data_structures.py:83-92)
        overlay = crop_img.copy()
        output = crop_img.copy()
        cv2.rectangle(overlay, (bbox[1], bbox[0]), (bbox[3], bbox[2]), (0, 0, 255), -1)
        cv2.addWeighted(overlay, 0.6, output, 0.4, 0, output)
        cv2.imwrite(str(export_dir / "overlay" / name), output)

        # the segment's crop from the full frame (data_structures.py:94-113)
        ey1, ex1, ey2, ex2 = expand_bbox(bbox, cfg.min_seg_size)
        seg = frame_bgr[ey1 + y1 : ey2 + y1, ex1 + x1 : ex2 + x1]
        if seg.size:
            cv2.imwrite(str(export_dir / name), seg)
    return n
