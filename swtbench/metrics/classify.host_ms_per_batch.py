"""Host milliseconds a batch that the segment filter's host part takes:
cutting each segment's crop from its whole frame (`classify_crop`) and
packing the crops into canvases (`classify_pack`), RunMetrics.stage_seconds
over the host part's batches."""


def read(run):
    s = [run.stage_seconds[k] for k in ("classify_crop", "classify_pack")
         if k in run.stage_seconds]
    return 1e3 * sum(s) / run.host_batches if s and run.crops and run.host_batches else None
