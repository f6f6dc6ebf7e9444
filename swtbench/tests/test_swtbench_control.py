"""The check's control and the program's faults come out not correct.

The control is the reference put in the program's place, one precision
step below what the configuration states; the faults are planted in the
program's timed path underneath a whole run (the harness's look for a card
skipped), among them two whole-pixel faults: a crop off by one column, and
under stabilisation every shift off by one.  Both at the tiny CPU size; swtbench/control.py reads the
control on the card at the cells' own size."""

import copy
import dataclasses

import pytest
import torch

import swiftwatcher_tpu_torch.pipeline.runner as runner
import swiftwatcher_tpu_torch.pipeline.window as window
from swtbench import compare, control, run, spec

CELLS = ["count.dusk", "accuracy.jitter"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, tiny):
    cell = spec.load_cell(name)
    (r,) = control.readings(cell, [31], 3 * 84 * 2, False, ["tf32"], "cpu", shrink=tiny)
    correct, checks = compare.judge(r["numbers"], cell.limits)
    assert not correct, checks


def _half_the_batch(real):
    def localize(gray, cfg, with_bbox=False, stab_ref=None):
        table, iters = real(gray, cfg, with_bbox=with_bbox, stab_ref=stab_ref)
        table.valid[gray.shape[0] // 2:] = False
        return table, iters
    return "localize_windows_gray", localize, {}


def _state_unchanged(real):
    def track(state, *args, **kw):
        before = copy.deepcopy(state)
        _, events = real(state, *args, **kw)
        return before, events
    # the cells' own frame and one window a batch, so that tracks run
    # across the batches' seams (at the tiny size birds show near the
    # mouth only)
    return "track_window", track, {"height": 1080, "width": 1920, "blocks": 1,
                                   "batch_windows": 1}


def _answer_altered(real):
    def localize(gray, cfg, with_bbox=False, stab_ref=None):
        table, iters = real(gray, cfg, with_bbox=with_bbox, stab_ref=stab_ref)
        return dataclasses.replace(table, sum_y=table.sum_y + 3 * table.area), iters
    return "localize_windows_gray", localize, {}


def _crop_off_by_one(real):
    def localize(gray, cfg, with_bbox=False, stab_ref=None):
        # the crop one column to the right: every centroid moves 1 px
        moved = torch.cat((gray[..., 1:], gray[..., -1:]), dim=-1)
        return real(moved, cfg, with_bbox=with_bbox, stab_ref=stab_ref)
    return "localize_windows_gray", localize, {}


def _shift_off_by_one(real):
    def stabilize(gray, max_shift, ref=None):
        # every chosen shift one column short, and the frames aligned so
        aligned, shifts = real(gray, max_shift, ref)
        moved = torch.cat((aligned[..., :1], aligned[..., :-1]), dim=-1)
        return moved, shifts - torch.tensor([0, 1], dtype=shifts.dtype, device=shifts.device)
    return "stabilize_window", stabilize, {}


FAULTS = [(f, name) for f in (_half_the_batch, _state_unchanged, _answer_altered)
          for name in CELLS] + [(_crop_off_by_one, "count.dusk"),
                                (_shift_off_by_one, "accuracy.jitter")]


@pytest.mark.parametrize("fault,name", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, tiny, monkeypatch):
    attr = fault(None)[0]
    module = window if attr == "stabilize_window" else runner
    _, broken, size = fault(getattr(module, attr))
    monkeypatch.setattr(module, attr, broken)
    result, notes = run.run_cell(spec.load_cell(name), 77, 5.0 if size else 2.0, False, "cpu",
                                 shrink=dict(tiny, **size))
    assert not result["correct"], notes


@pytest.mark.card
@pytest.mark.parametrize("fault,name", [(_crop_off_by_one, "count.dusk"),
                                        (_shift_off_by_one, "accuracy.jitter")])
def test_a_whole_pixel_fault_at_the_cells_size(name, fault, card, monkeypatch):
    attr = fault(None)[0]
    module = window if attr == "stabilize_window" else runner
    monkeypatch.setattr(module, attr, fault(getattr(module, attr))[1])
    run.pin_caches()
    result, notes = run.run_cell(spec.load_cell(name), 2**31 + 77, 4.0, False, card)
    print(*notes[-len(result["checks"]) - 2:], sep="\n")
    assert not result["correct"], notes
