"""Device milliseconds of the tracking scan T1 a batch: the kernels
launched inside the swt_track_scan ranges over the traced batches'
track_dispatch ranges."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = tr.range_kernel_s.get("swt_track_scan", 0.0)
    n = tr.range_count.get("track_dispatch", 0)
    return 1e3 * busy / n if busy > 0 and n else None
