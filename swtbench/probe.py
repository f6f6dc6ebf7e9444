"""What the benchmark reads of the program while its run_video call runs.

`Probe`, for the life of a `with` block, wraps three names that the port's
runner looks up at each call, and puts them back after:

  runner.localize_windows_gray  the timed path's localisation: each
                                batch's region table (area, sum_y and
                                sum_x of the 256 labels of every frame) is
                                copied on the device into a slot set aside
                                beforehand
  window.stabilize_window       its stabilisation: each batch's (dy, dx)
                                shifts, likewise
  runner.RunMetrics             the call's metrics object, so that its
                                stage seconds can be read as each batch
                                completes

The copies are queued on the stream behind the work that makes the table:
the host neither waits for them nor allocates (4.1 MB a batch of 64
windows, against some 0.4 s of device work).  Batches past the slots set
aside go unrecorded, so `correct` then reads the first `slots` batches.
The tables are read back once the call has returned.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

LABELS = 256


class Probe:
    def __init__(self, device, slots: int, windows_per_batch: int, window_frames: int):
        shape = (slots, windows_per_batch, window_frames)
        self.tables = torch.zeros((slots, 3, *shape[1:], LABELS), dtype=torch.int32,
                                  device=device)
        self.shifts = torch.zeros((*shape, 2), dtype=torch.int32, device=device)
        self.slots = slots
        self.metrics = None
        self.reset()

    def reset(self) -> None:
        """Start recording at the first slot again (the timed call's)."""
        self.n_tables = self.n_shifts = 0
        self.stabilized = False

    def __enter__(self) -> "Probe":
        from swiftwatcher_tpu_torch.pipeline import runner, window

        self._saved = [(runner, "localize_windows_gray", runner.localize_windows_gray),
                       (window, "stabilize_window", window.stabilize_window),
                       (runner, "RunMetrics", runner.RunMetrics)]
        localize, stabilize, metrics_cls = (f for _, _, f in self._saved)
        probe = self

        def localize_windows_gray(*args, **kw):
            table, iters = localize(*args, **kw)
            if probe.n_tables < probe.slots:
                b = table.area.shape[0]
                slot = probe.tables[probe.n_tables]
                for i, a in enumerate((table.area, table.sum_y, table.sum_x)):
                    slot[i, :b].copy_(a, non_blocking=True)
            probe.n_tables += 1
            return table, iters

        def stabilize_window(*args, **kw):
            aligned, shifts = stabilize(*args, **kw)
            if probe.n_shifts < probe.slots and shifts.dim() == 3:
                probe.shifts[probe.n_shifts, :shifts.shape[0]].copy_(shifts, non_blocking=True)
                probe.stabilized = True
            probe.n_shifts += 1
            return aligned, shifts

        class RunMetrics(metrics_cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.metrics = self

        runner.localize_windows_gray = localize_windows_gray
        window.stabilize_window = stabilize_window
        runner.RunMetrics = RunMetrics
        return self

    def __exit__(self, *exc) -> None:
        for module, name, value in self._saved:
            setattr(module, name, value)

    def frames(self, n_frames: int):
        """(segments, shifts) of the stream's first `n_frames` frames that
        were recorded: a list of each frame's centroids (row, col) in label
        order, and an (F, 2) int array of the shifts, or None where no
        batch was stabilised.  Batch i holds the stream's windows i*B to
        i*B + B - 1."""
        n = min(self.n_tables, self.slots)
        if self.tables.device.type == "cuda":
            torch.cuda.synchronize(self.tables.device)
        tables = self.tables[:n].cpu().numpy()
        area, sum_y, sum_x = (tables[:, i].reshape(-1, LABELS) for i in range(3))
        F = min(n_frames, area.shape[0])
        segments: List[list] = [[] for _ in range(F)]
        rows, labels = np.nonzero(area[:F, 1:] > 0)
        labels += 1
        a = area[rows, labels].astype(np.float64)
        ys, xs = sum_y[rows, labels] / a, sum_x[rows, labels] / a
        for r, y, x in zip(rows.tolist(), ys.tolist(), xs.tolist()):
            segments[r].append((y, x))
        shifts: Optional[np.ndarray] = None
        if self.stabilized:
            m = min(self.n_shifts, self.slots)
            shifts = self.shifts[:m].cpu().numpy().reshape(-1, 2)[:F]
        return segments, shifts
