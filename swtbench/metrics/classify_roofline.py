"""Share of the segment filter's forward roofline: SqueezeNet 1.0's least
time over the real crops classified while traced (swtbench/roofline.py:
squeezenet_forward at the configuration's input size; the padded rows are
not counted, so padding counts against the share) over the device time of
the kernels launched inside the program's classify_forward ranges."""

from swtbench import roofline


def read(run):
    tr = run.trace
    if tr is None or not run.traced_crops:
        return None
    busy = tr.range_kernel_s.get("classify_forward", 0.0)
    if busy <= 0:
        return None
    need = roofline.squeezenet_forward(run.traced_crops, run.cfg.cnn_input_size)
    return 100.0 * roofline.bound_s(*need) / busy
