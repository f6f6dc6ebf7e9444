"""Device milliseconds of stabilisation a batch: the kernels launched
inside the program's `stabilize` ranges over their count (one a batch)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy, n = tr.range_kernel_s.get("stabilize", 0.0), tr.range_count.get("stabilize", 0)
    return 1e3 * busy / n if busy > 0 and n else None
