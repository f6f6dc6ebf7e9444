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

and, given `crop_rows` (a segment filter runs), three more:

  squeezenet.forward            the filter's forward, which its `predict`
                                looks up at each call on every classify
                                path: each batch's (crops, 2) logits are
                                copied on the device into rows set aside
                                beforehand, `crop_rows` a batch
  runner.pack_fused             the fused path's pack: which crop each
                                row of the forward is (its meta's flat
                                slot; degenerate and padding rows skipped)
  SqueezeNetSegmentFilter.batch_call, ._frame_images
                                the unfused path: the crops in the order
                                the filter packs them

The copies are queued on the stream behind the work that makes the table:
the host neither waits for them nor allocates (4.1 MB a batch of 64
windows, against some 0.4 s of device work).  Batches past the slots set
aside go unrecorded, so `correct` then reads the first `slots` batches.
The tables and logits are read back once the call has returned.  A
batch's crops are counted from the program's own pack, recorded or not.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

LABELS = 256


class Probe:
    def __init__(self, device, slots: int, windows_per_batch: int, window_frames: int,
                 crop_rows: int = 0):
        shape = (slots, windows_per_batch, window_frames)
        self.tables = torch.zeros((slots, 3, *shape[1:], LABELS), dtype=torch.int32,
                                  device=device)
        self.shifts = torch.zeros((*shape, 2), dtype=torch.int32, device=device)
        self.logits = (torch.zeros((slots * crop_rows, 2), dtype=torch.float32, device=device)
                       if crop_rows else None)
        self.slots = slots
        self.B, self.T = windows_per_batch, window_frames
        self.metrics = None
        self.reset()

    def reset(self) -> None:
        """Start recording at the first slot again (the timed call's)."""
        self.n_tables = self.n_shifts = 0
        self.stabilized = False
        # crops classified, by batch; each recorded crop's (row of
        # self.logits, batch, b, t, its index among the frame's segments)
        self.crops: Dict[int, int] = {}
        self.crops_by_path = {"fused": 0, "unfused": 0}
        self.crop_rows: List[tuple] = []
        self._rows = 0
        # the crops of the forward about to run: (b, t, index) a row, None
        # for a row that is no crop (fused path); or the unfused path's
        # frames as the filter packs them
        self._pending: Optional[list] = None
        self._collect: Optional[list] = None

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
        if self.logits is not None:
            self._wrap_filter()
        return self

    def _wrap_filter(self) -> None:
        from swiftwatcher_tpu_torch.models import classifier, squeezenet
        from swiftwatcher_tpu_torch.pipeline import runner

        cls = classifier.SqueezeNetSegmentFilter
        self._saved += [(squeezenet, "forward", squeezenet.forward),
                        (runner, "pack_fused", runner.pack_fused),
                        (cls, "batch_call", cls.batch_call),
                        (cls, "_frame_images", cls._frame_images)]
        forward, pack_fused, batch_call, frame_images = (f for _, _, f in self._saved[-4:])
        probe = self

        def forward_(params, x):
            out = forward(params, x)
            probe._record(out)
            return out

        def pack_fused_(segment_filter, view, frames, crop_region, timers=None):
            packed = pack_fused(segment_filter, view, frames, crop_region, timers=timers)
            if packed is not None:
                _, T, K = view.valid.shape
                slot, drop = packed[1][2].tolist(), packed[1][3].tolist()
                rows = []
                for s, d in zip(slot, drop):
                    if s >= len(view.valid) * T * K:
                        break
                    rows.append(None if d else (s // K // T, s // K % T, s % K))
                probe._pending = rows
            return packed

        def batch_call_(self, table, frames, crop_region, timers=None):
            probe._collect = []
            try:
                return batch_call(self, table, frames, crop_region, timers=timers)
            finally:
                probe._collect = None

        def frame_images_(self, table, index, frame_bgr, crop_region):
            images, degenerate = frame_images(self, table, index, frame_bgr, crop_region)
            if probe._collect is not None:
                probe._collect.append((index, degenerate))
            return images, degenerate

        squeezenet.forward = forward_
        runner.pack_fused = pack_fused_
        cls.batch_call = batch_call_
        cls._frame_images = frame_images_

    def _record(self, out: torch.Tensor) -> None:
        """Copy a forward's logits, row by row as the pack laid them out."""
        rows, self._pending = self._pending, None
        path = "fused"
        if rows is None and self._collect is not None:
            path = "unfused"
            rows = [(b, t, i) for (b, t), degenerate in self._collect
                    for i, d in enumerate(degenerate) if not d]
            self._collect = None
        if rows is None:
            return
        batch = self.metrics.batches
        n_crops = sum(r is not None for r in rows)
        self.crops[batch] = self.crops.get(batch, 0) + n_crops
        self.crops_by_path[path] += n_crops
        n = len(rows)
        if batch < self.slots and self._rows + n <= len(self.logits):
            self.logits[self._rows:self._rows + n].copy_(out[:n], non_blocking=True)
            self.crop_rows += [(self._rows + i, batch, *r) for i, r in enumerate(rows)
                               if r is not None]
            self._rows += n

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

    def segment_logits(self, n_frames: int) -> Optional[dict]:
        """{(frame, index among its segments in label order): (2,) float32
        logits} of the crops recorded in the stream's first `n_frames`
        frames; None where no segment filter ran."""
        if self.logits is None:
            return None
        logits = self.logits[:self._rows].cpu().numpy()
        out = {}
        for row, batch, b, t, i in self.crop_rows:
            fn = (batch * self.B + b) * self.T + t
            if fn < n_frames:
                out[(fn, i)] = logits[row]
        return out
