"""Share of K2's roofline: the bytes connected-component labelling needs
for the traced batches' frames (the uint8 foreground plane in, the uint8
label plane out) at the HBM's bandwidth, over the device time of the
kernels launched inside the swt_label_rank_fused ranges."""

from swtbench import roofline


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = tr.range_kernel_s.get("swt_label_rank_fused", 0.0)
    n = tr.range_count.get("localize_dispatch", 0)
    if busy <= 0 or not n:
        return None
    h, w = run.crop_hw
    frames = n * run.windows_per_batch * run.window_frames
    need = frames * roofline.frame_plane_bytes(h * w, run.stabilize)["k2"]
    return 100.0 * roofline.bound_s(need) / busy
