"""Host milliseconds a batch spends in the runner's localisation: the
dispatch of its work and the IALM loop's per-trip reads of its stop flag
(RunMetrics.stage_seconds["localize"] over the host part's batches)."""


def read(run):
    s = run.stage_seconds.get("localize")
    return None if s is None or not run.host_batches else 1e3 * s / run.host_batches
