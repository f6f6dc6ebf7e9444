"""Trips of the batched IALM loop a batch over the window's host part: the
loop runs until the slowest of a batch's windows stops, so a batch takes
the most of its windows' IALM counts (the program's per-window counts, in
batches of windows_per_batch)."""


def read(run):
    it, b = run.ialm_iters, run.windows_per_batch
    if not it or not b:
        return None
    batches = [max(it[i:i + b]) for i in range(0, len(it), b)]
    return sum(batches) / len(batches)
