"""Share of the frames that took the CCL slow path (K5, K3, K4) in the
window's host part: the port's label_components.slow_path_frames counter."""


def read(run):
    if run.slow_path_frames is None or not run.host_frames:
        return None
    return 100.0 * run.slow_path_frames / run.host_frames
