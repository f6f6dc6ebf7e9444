"""CPU milliseconds of the process (every thread, getrusage) a frame over
the window's host part."""


def read(run):
    return 1e3 * run.cpu_s / run.host_frames if run.host_frames else None
