"""Share of the traced window in which nothing ran on the card: 100 x (1 -
the union of kernel, copy and memset intervals / the window)."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
