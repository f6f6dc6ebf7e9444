"""The program's `sync.*` spans a batch: the blocking reads of the device
that the main thread's code marks as such (the IALM stop flag and eigh,
the CCL flags, the label maximum and bincounts, consume's reads), counted
as the `sync.` ranges that closed in the trace over the traced batches'
localize_dispatch ranges.  It counts marked read sites, not the runtime's
synchronising calls: one span may hold several (the event buffer's
read-back holds eight), and a read without a span is not counted."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n = tr.range_count.get("localize_dispatch", 0)
    syncs = sum(c for name, c in tr.range_count.items() if name.startswith("sync."))
    return syncs / n if syncs and n else None
