"""Share of the window's host part that the main thread spent waiting on
the prefetch worker (RunMetrics.stage_seconds["prefetch_wait"] over the
host part's seconds)."""


def read(run):
    wait = run.stage_seconds.get("prefetch_wait")
    return None if wait is None or run.host_s <= 0 else 100.0 * wait / run.host_s
