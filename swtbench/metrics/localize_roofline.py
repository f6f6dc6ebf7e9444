"""Share of the localisation's roofline: the least time of the traced
batches' localisation work (swtbench/roofline.py: IALM trips at the
measured mean of the windows dispatched while traced, stabilisation, K1,
K2 and props, from the shapes) over the device time of the kernels launched
inside the localize_dispatch ranges."""

from swtbench import roofline


def read(run):
    tr = run.trace
    if tr is None or not run.traced_iters:
        return None
    n, busy = tr.range_count.get("localize_dispatch", 0), tr.range_kernel_s.get("localize_dispatch", 0.0)
    if not n or busy <= 0:
        return None
    h, w = run.crop_hw
    trips = sum(run.traced_iters) / len(run.traced_iters)
    n_bytes, n_ops = roofline.localize_batch(run.windows_per_batch, run.window_frames, h * w,
                                             trips, run.cfg, run.stabilize)
    return 100.0 * n * roofline.bound_s(n_bytes, n_ops) / busy
