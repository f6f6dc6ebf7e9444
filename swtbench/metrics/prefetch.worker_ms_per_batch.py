"""Host milliseconds a batch of the prefetch worker's own work: its
`prefetch_read` (the windows into the pinned buffer) and `prefetch_upload`
(the copy's dispatch) spans, RunMetrics.stage_seconds over the host part's
batches."""


def read(run):
    s = [run.stage_seconds[k] for k in ("prefetch_read", "prefetch_upload")
         if k in run.stage_seconds]
    return 1e3 * sum(s) / run.host_batches if s and run.host_batches else None
