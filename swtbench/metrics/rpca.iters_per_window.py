"""Mean IALM trips of a window (the program's per-window count) over the
window's host part."""


def read(run):
    it = run.ialm_iters
    return sum(it) / len(it) if it else None
