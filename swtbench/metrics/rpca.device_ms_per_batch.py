"""Device milliseconds of the IALM solve a batch: the kernels launched
inside the program's `ialm_solve` ranges over their count (one a batch)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy, n = tr.range_kernel_s.get("ialm_solve", 0.0), tr.range_count.get("ialm_solve", 0)
    return 1e3 * busy / n if busy > 0 and n else None
