"""Host milliseconds a batch that the main thread spends in blocking reads
of the device: the program's `sync.*` spans (RunMetrics.stage_seconds)
over the host part's batches."""


def read(run):
    s = [v for k, v in run.stage_seconds.items() if k.startswith("sync.")]
    return 1e3 * sum(s) / run.host_batches if s and run.host_batches else None
