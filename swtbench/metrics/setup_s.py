"""Seconds from process start to the window's opening: CUDA start-up,
loading the kernels, making the traffic, the warm-up call and the timed
call's first batch."""


def read(run):
    return run.setup_s
