"""Mid-video checkpoint and resume.

The port's copy of swiftwatcher_tpu/utils/checkpoint.py, with the same JSON
format: the frame cursor, the live tracks (host tracker) or the TrackState
(device tracker), and the events found so far, written atomically every
few batches; `run_video` resumes from a checkpoint at its path.

  * Host and device checkpoints are marked ("tracker_impl") and cannot be
    resumed by the other tracker: the device state is a fixed-capacity
    TrackState.
  * A checkpoint carries a source fingerprint (file name and fps); loading
    it against another video raises.
  * Timestamps are stored as the JAX package stores them: ["tod",
    time of day] for a frame, ["raw", "00:00:00.000"] for a null frame.
    The port's stamp of a frame is its frame number (io/source.py), so a
    load takes each stamp from its frame number and reads checkpoints of
    either package.
  * The temporary file appends ".tmp" to the full name, so checkpoint paths
    that differ only in their suffix cannot collide.

pandas is not needed: the time of day is computed as frame_timestamp
computes it (io/export.py).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..io.export import NULL_TIMESTAMP
from ..pipeline.tracking import Event, SegmentTracker, Track


def _time_of_day(frame_number: int, fps: float) -> str:
    """frame_timestamp(frame_number, fps)'s time of day as pandas prints a
    Timedelta: pd.Timedelta(frame_number / fps, "s") in whole nanoseconds
    (whole seconds, plus the fraction rounded to 9 digits), then rounded to
    microseconds, half to even."""
    total_s = frame_number / fps
    base = int(total_s)
    ns = base * 10**9 + int(round(total_s - base, 9) * 10**9)
    us, rem = divmod(ns, 1000)
    if rem > 500 or (rem == 500 and us % 2):
        us += 1
    us %= 86400 * 10**6
    secs, frac = divmod(us, 10**6)
    return "0 days {:02d}:{:02d}:{:02d}.{:06d}".format(
        secs // 3600, secs // 60 % 60, secs % 60, frac)


def _stamp_to_json(frame_number: int, fps: float):
    if frame_number < 0:
        return ["raw", NULL_TIMESTAMP]
    return ["tod", _time_of_day(frame_number, fps)]


def _events_to_json(events: List[Event], fps: float):
    return [
        {
            "first_centroid": list(e.first_centroid),
            "last_centroid": list(e.last_centroid),
            "frame_number": int(e.frame_number),
            "timestamp": _stamp_to_json(int(e.frame_number), fps),
        }
        for e in events
    ]


def _events_from_json(raw) -> List[Event]:
    return [
        Event(
            first_centroid=tuple(e["first_centroid"]),
            last_centroid=tuple(e["last_centroid"]),
            frame_number=e["frame_number"],
            timestamp=e["frame_number"],
        )
        for e in raw
    ]


def source_fingerprint(source) -> dict:
    """Identity stamp checked at resume.  Frame counts are left out:
    resuming an --end-truncated run against the full video is allowed."""
    return {
        "name": None if source.filepath is None else Path(source.filepath).name,
        "fps": float(source.fps),
    }


def _check_fingerprint(state: dict, expect: Optional[dict], path: Path) -> None:
    saved = state.get("source")
    if saved is None or expect is None:
        return  # an older checkpoint, or the caller opted out
    if saved != expect:
        raise ValueError(
            f"{path} was written for source {saved}, but this run reads "
            f"{expect}; refusing to resume (delete the checkpoint or point "
            "it at a per-video path)"
        )


def _atomic_write_json(path: Path, state: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(state, fh)
    tmp.replace(path)


def _read(path: Path, source_info: Optional[dict], want_device: bool) -> Optional[dict]:
    path = Path(path)
    if not path.exists():
        return None
    with open(path) as fh:
        state = json.load(fh)
    is_device = state.get("tracker_impl") == "device"
    if is_device != want_device:
        kind, other = ("device", "host") if is_device else ("host", "device")
        raise ValueError(
            f"{path} is a {kind}-tracker checkpoint; resume it with "
            f"tracker_impl='{kind}', not '{other}' (state formats are not "
            "interchangeable)"
        )
    _check_fingerprint(state, source_info, path)
    return state


def save_checkpoint(
    path: Path,
    next_frame_number: int,
    frames_processed: int,
    tracker: SegmentTracker,
    fps: float,
    source_info: Optional[dict] = None,
) -> None:
    """The host tracker's live tracks and events."""
    _atomic_write_json(path, {
        "next_frame_number": int(next_frame_number),
        "frames_processed": int(frames_processed),
        "source": source_info,
        "tracks": [
            {
                "centroid": list(t.centroid),
                "frame_number": int(t.frame_number),
                "timestamp": _stamp_to_json(int(t.frame_number), fps),
                "hist_len": int(t.hist_len),
                "hist_first": None if t.hist_first is None else list(t.hist_first),
            }
            for t in tracker.prev
        ],
        "events": _events_to_json(tracker.events, fps),
    })


def load_checkpoint(
    path: Path, tracker: SegmentTracker, source_info: Optional[dict] = None
) -> Optional[Tuple[int, int]]:
    """Restore the host tracker in place; (next_frame_number,
    frames_processed), or None when there is no checkpoint."""
    state = _read(path, source_info, want_device=False)
    if state is None:
        return None
    tracker.prev = [
        Track(
            centroid=tuple(t["centroid"]),
            frame_number=t["frame_number"],
            timestamp=t["frame_number"],
            hist_len=t["hist_len"],
            hist_first=None if t["hist_first"] is None else tuple(t["hist_first"]),
        )
        for t in state["tracks"]
    ]
    tracker.events = _events_from_json(state["events"])
    return state["next_frame_number"], state["frames_processed"]


def save_checkpoint_device(
    path: Path,
    next_frame_number: int,
    frames_processed: int,
    dev_state,                      # pipeline.tracking_device.TrackState
    events: List[Event],
    fps: float,
    source_info: Optional[dict] = None,
) -> None:
    """The device tracker's TrackState and the events drained so far."""
    _atomic_write_json(path, {
        "tracker_impl": "device",
        "next_frame_number": int(next_frame_number),
        "frames_processed": int(frames_processed),
        "source": source_info,
        "dev_state": {k: v.tolist() for k, v in dev_state.to_numpy().items()},
        "events": _events_to_json(events, fps),
    })


def load_checkpoint_device(
    path: Path, source_info: Optional[dict] = None, device=torch.device("cpu")
):
    """(next_frame_number, frames_processed, TrackState on `device`,
    events), or None when there is no checkpoint."""
    from ..pipeline.tracking_device import TrackState

    state = _read(path, source_info, want_device=True)
    if state is None:
        return None
    dev_state = TrackState.from_numpy(state["dev_state"], device)
    return (state["next_frame_number"], state["frames_processed"], dev_state,
            _events_from_json(state["events"]))
