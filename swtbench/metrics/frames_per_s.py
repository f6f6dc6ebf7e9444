"""Frames of the batches completed in the window, over the window's
seconds (host clock): the rate a roost monitor's night of footage runs at."""


def read(run):
    return run.frames_in_window / run.window_s
