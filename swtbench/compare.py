"""The numbers that decide `correct`, each held to its limit.

The program's results are what the timed call produced: its events (first
and last centroid, frame number), its predicted and rejected totals, each
window's IALM iterations, and, as swtbench/probe.py recorded them on the
timed path, each frame's segment table (the centroids of its labels, in
label order) and, under stabilisation, each frame's (dy, dx) shift.  The
reference's are the same quantities for the same stream
(swtbench/reference), per frame and window of the base clip that the
stream loops.  Two centroids are the same when they lie within MATCH_PX of
each other; two events are the same event when they end on the same frame
and both their centroids are the same.  Within one frame, pairs are made
nearest first.  MATCH_PX lies below 1 px, the least move of a whole-pixel
fault (a crop or a shift off by one), and above the quarter pixel or less
by which one flipped edge pixel moves a centroid.

  iters_gap              the largest gap, over the stream's windows,
                         between the program's IALM iterations and the
                         reference's
  segment_frames_off_pct frames whose segments do not pair one to one, as
                         a share of the frames compared
  shift_frames_off_pct   frames whose stabilisation shift differs, as a
                         share of the frames compared (0 where neither
                         side stabilises)
  unmatched_events_pct   events of either side without a match, as a share
                         of the reference's events
  totals_gap_pct         |predicted gap| + |rejected gap|, as a share of
                         the reference's events

and, only where the program ran a segment filter, over the crops of the
frames compared (a crop is a frame's segment by its index in label order;
an empty slice is no crop):

  logit_gap              the largest |program - reference| over both
                         logits of every crop that both sides classified
  keep_off_pct           crops whose keep decision (argmax 1) differs, as
                         a share of the crops compared; a crop that only
                         one side classified counts as differing

A cell's limits (swtbench/checks/<cell>.json) name the numbers it compares.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

MATCH_PX = 0.5


def _event_gap(a, b) -> float:
    return max(math.dist(a[0], b[0]), math.dist(a[1], b[1]))


def unpaired(mine: Sequence, theirs: Sequence, gap=math.dist) -> int:
    """Items of either list left without a partner within MATCH_PX, pairs
    made nearest first."""
    left, alone = list(theirs), 0
    for e in mine:
        best = min(range(len(left)), key=lambda i: gap(e, left[i]), default=None)
        if best is not None and gap(e, left[best]) <= MATCH_PX:
            left.pop(best)
        else:
            alone += 1
    return alone + len(left)


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """program: {"events", "predicted", "rejected", "iters", "segments",
    "shifts", "logits"}, its iters per window and its segments and shifts
    per frame of the stream (the frames compared), its logits per crop
    (None without a filter); reference: the same, per window and frame of
    the base clip."""
    ref_iters = list(reference["iters"])
    U = len(ref_iters)
    iters_gap = max((abs(int(p) - int(ref_iters[k % U])) for k, p in enumerate(program["iters"])),
                    default=0)
    by_fn: Dict[int, List[list]] = defaultdict(lambda: [[], []])
    for side, result in enumerate((program, reference)):
        for e in result["events"]:
            by_fn[int(e[2])][side].append(e)
    unmatched = sum(unpaired(mine, theirs, _event_gap) for mine, theirs in by_fn.values())
    n_ref = max(len(reference["events"]), 1)
    totals = (abs(program["predicted"] - reference["predicted"])
              + abs(program["rejected"] - reference["rejected"]))

    segs, ref_segs = program["segments"], reference["segments"]
    N = len(ref_segs)
    seg_off = sum(1 for fn, s in enumerate(segs) if unpaired(s, ref_segs[fn % N]))
    shifts, ref_shifts = program["shifts"], reference["shifts"]
    if shifts is None and ref_shifts is None:
        shift_off = 0
    elif shifts is None or ref_shifts is None:
        shift_off = max(len(segs), 1)
    else:
        shift_off = sum(1 for fn in range(len(segs))
                        if fn >= len(shifts) or tuple(shifts[fn]) != tuple(ref_shifts[fn % N]))
    n_frames = len(segs)
    out = {
        "iters_gap": float(iters_gap),
        # no frame recorded is no frame shown correct
        "segment_frames_off_pct": 100.0 * seg_off / n_frames if n_frames else 100.0,
        "shift_frames_off_pct": 100.0 * shift_off / max(n_frames, 1),
        "unmatched_events_pct": 100.0 * unmatched / n_ref,
        "totals_gap_pct": 100.0 * totals / n_ref,
    }
    if program.get("logits") is not None:
        out.update(_classified(program["logits"], reference["logits"], n_frames))
    return out


def _classified(mine: dict, ref_logits: list, n_frames: int) -> Dict[str, float]:
    """logit_gap and keep_off_pct of the program's {(frame, index): logits}
    against the reference's per clip frame lists."""
    N = len(ref_logits)
    theirs = {(fn, i): lg for fn in range(n_frames) for i, lg in enumerate(ref_logits[fn % N])
              if lg is not None}
    gap, off = 0.0, 0
    for key in mine.keys() | theirs.keys():
        a, b = mine.get(key), theirs.get(key)
        if a is None or b is None:
            off += 1
            continue
        gap = max(gap, float(np.max(np.abs(np.asarray(a, np.float64) - b))))
        off += int(np.argmax(a)) != int(np.argmax(b))
    n = len(mine.keys() | theirs.keys())
    return {"logit_gap": gap, "keep_off_pct": 100.0 * off / n if n else 0.0}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    checks = {k: {"value": values[k], "limit": float(limits[k])} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
