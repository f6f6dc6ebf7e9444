"""Device milliseconds of the segment filter's fused range a batch: the
kernels launched inside the program's classify_track_fused ranges (the
crops' upload, the PIL-exact preprocess, the forward, the keep scatter and
the tracking scan T1) over their count (one a batch with crops)."""


def read(run):
    tr = run.trace
    if tr is None or not run.traced_crops:
        return None
    busy = tr.range_kernel_s.get("classify_track_fused", 0.0)
    n = tr.range_count.get("classify_track_fused", 0)
    return 1e3 * busy / n if busy > 0 and n else None
