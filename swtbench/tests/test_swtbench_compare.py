"""The compared numbers on hand-made results."""

import numpy as np
import pytest

from swtbench import compare


def _ev(fn, y, x):
    return ((y, x), (y + 10.0, x + 1.0), fn)


def _results(events, predicted, rejected, iters, segments, shifts=None):
    return {"events": events, "predicted": predicted, "rejected": rejected, "iters": iters,
            "segments": segments, "shifts": shifts}


def test_numbers_pair_events_by_frame_and_distance():
    ref = _results([_ev(10, 5.0, 5.0), _ev(10, 50.0, 50.0), _ev(20, 5.0, 5.0)], 2, 1, [14, 15],
                   [[], [(3.0, 4.0)]])
    prog = _results([_ev(10, 50.4, 50.0), _ev(10, 5.0, 5.0), _ev(21, 5.0, 5.0)], 3, 0,
                    [14, 15, 16, 15], [[], [(3.0, 4.0)], [], [(3.0, 4.0)]])
    n = compare.numbers(prog, ref)
    assert n["iters_gap"] == 2.0                  # window 2 is the clip's window 0
    assert n["unmatched_events_pct"] == pytest.approx(100 * 2 / 3)
    assert n["totals_gap_pct"] == pytest.approx(100 * 2 / 3)
    assert n["segment_frames_off_pct"] == 0.0     # frames 2, 3 are the clip's 0, 1
    assert n["shift_frames_off_pct"] == 0.0       # neither side stabilises
    assert compare.numbers(ref, ref)["unmatched_events_pct"] == 0.0


def test_a_whole_pixel_is_no_match():
    ref = _results([_ev(10, 5.0, 5.0)], 1, 0, [14], [[(3.0, 4.0)], [(7.0, 7.0), (9.0, 1.0)]])
    prog = _results([_ev(10, 5.0, 6.0)], 1, 0, [14],
                    [[(3.0, 5.0)], [(9.0, 1.2), (7.2, 7.0)]])
    n = compare.numbers(prog, ref)
    assert n["unmatched_events_pct"] == 200.0     # one on each side
    # frame 0 is a pixel off; frame 1 pairs nearest first, in any order
    assert n["segment_frames_off_pct"] == 50.0
    prog["segments"][1].append((50.0, 50.0))
    assert compare.numbers(prog, ref)["segment_frames_off_pct"] == 100.0


def test_shifts_are_compared_frame_by_frame():
    ref = _results([], 0, 0, [14], [[], []], np.array([[1, -2], [0, 3]]))
    prog = _results([], 0, 0, [14], [[], [], [], []], np.array([[1, -2], [0, 3], [1, -2], [0, 2]]))
    assert compare.numbers(prog, ref)["shift_frames_off_pct"] == 25.0
    prog["shifts"] = None                         # a stabilised cell that recorded none
    assert compare.numbers(prog, ref)["shift_frames_off_pct"] == 100.0
    prog["shifts"], prog["segments"] = np.zeros((0, 2), int), []
    assert compare.numbers(prog, ref)["segment_frames_off_pct"] == 100.0


def test_judge_holds_every_named_number_to_its_limit():
    ok, checks = compare.judge({"a": 1.0, "b": 0.0, "c": 9.0}, {"a": 1, "b": 0})
    assert ok and set(checks) == {"a", "b"}
    assert not compare.judge({"a": 1.5, "b": 0.0}, {"a": 1, "b": 0})[0]
