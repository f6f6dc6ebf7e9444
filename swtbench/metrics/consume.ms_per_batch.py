"""Host milliseconds a batch spends in consume: the read-back of its
events and IALM counts and the events' bookkeeping
(RunMetrics.stage_seconds["consume"] over the host part's batches)."""


def read(run):
    s = run.stage_seconds.get("consume")
    return None if s is None or not run.host_batches else 1e3 * s / run.host_batches
