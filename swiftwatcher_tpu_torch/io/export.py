"""Results export: the reference's six PREDICTED/REJECTED CSVs.

Reproduces io_data.py:19-135 byte-for-byte at the CSV level: a full
per-frame (timestamp, framenumber) MultiIndex timeline at (1/fps)*1e9 ns
steps rounded to microseconds, labeled events grouped into predicted
(label > 0) and rejected (label == 0) counts, and six files

    {total}-swifts_{full|events-only}_{usec|sec|min}.csv

with columns timestamp, framenumber, predicted, rejected (per-second and
per-minute files drop framenumber via index flooring).  Also provides the
--debug run-directory versioning (io_data.py:193-213) and the CSV round
trips the accuracy corpus scores with (io_data.py:143-190).

The port's copy of swiftwatcher_tpu/io/export.py.  pandas is imported inside
the functions that need it, so importing the port needs no pandas.
"""

from __future__ import annotations

import threading
from datetime import date
from glob import glob
from pathlib import Path

import numpy as np

# The timestamp of a null frame (out-of-range read, frame number -1),
# io_video.py:40-44.
NULL_TIMESTAMP = "00:00:00.000"


def frame_timestamp(frame_number: int, fps: float):
    """Constant-fps frame timestamp, a pd.Timestamp (io_video.py:74-82)."""
    import pandas as pd

    total_s = frame_number / fps
    return (pd.Timestamp("00:00:00.000") + pd.Timedelta(total_s, "s")).round(freq="us")


def _timeline(fps: float, start: int, end: int):
    """Empty per-frame timeline over [start, end] inclusive
    (io_data.py:33-62)."""
    import pandas as pd

    nano = (1 / fps) * 1e9
    num = end - start + 1
    t0 = pd.Timestamp("00:00:00.000000") + pd.Timedelta(start * nano, "ns")
    t1 = t0 + pd.Timedelta((num - 1) * nano, "ns")
    stamps = pd.date_range(start=t0, end=t1, periods=num).round(freq="us")
    index = pd.MultiIndex.from_tuples(
        list(zip(stamps, np.arange(start, end + 1))), names=["timestamp", "framenumber"]
    )
    df = pd.DataFrame(index=index)
    df["predicted"] = None
    df["rejected"] = None
    return df


def _grouped_counts(df_labels, predicate, name: str):
    """Per-(timestamp, framenumber) event counts for one label class
    (io_data.py:65-85)."""
    sel = df_labels[predicate(df_labels["label"])]
    g = sel.reset_index().groupby(["timestamp", "framenumber"]).sum()
    g = g.drop(columns=["angle", "label"])
    g.columns = [name]
    if g.empty:
        # pandas quirk: combine_first with an EMPTY other casts the combined
        # frame to other.dtypes — int64 would choke on the timeline's None
        # placeholders.  A run whose events are all one class (e.g. zero
        # rejected) must still export.
        g = g.astype(object)
    return g


def export_results(
    save_directory: Path, df_labels, fps: float, start: int, end: int
) -> int:
    """Write the six CSVs; returns the total predicted count
    (io_data.py:19-30, 88-135)."""
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)

    empty = _timeline(fps, start, end)
    predicted = _grouped_counts(df_labels, lambda s: s > 0, "predicted")
    rejected = _grouped_counts(df_labels, lambda s: s == 0, "rejected")

    filled = empty.combine_first(rejected).combine_first(predicted).fillna(0)

    exact = filled.copy(deep=True)
    seconds = filled.copy(deep=True)
    seconds = seconds.set_index(seconds.index.levels[0].floor("s"))
    seconds = seconds.groupby(seconds.index).sum()
    minutes = filled.copy(deep=True)
    minutes = minutes.set_index(minutes.index.levels[0].floor("min"))
    minutes = minutes.groupby(minutes.index).sum()
    total = int(np.sum(exact["predicted"]))

    outputs = {
        "full_usec": exact,
        "events-only_usec": exact[~((exact["predicted"] == 0) & (exact["rejected"] == 0))],
        "full_sec": seconds,
        "events-only_sec": seconds[~((seconds["predicted"] == 0) & (seconds["rejected"] == 0))],
        "full_min": minutes,
        "events-only_min": minutes[~((minutes["predicted"] == 0) & (minutes["rejected"] == 0))],
    }
    for name, df in outputs.items():
        df.to_csv(str(save_directory / f"{total}-swifts_{name}.csv"))
    return total


_test_dir_lock = threading.Lock()


def generate_test_dir(parent_dir: Path) -> Path:
    """--debug run versioning: parent/<today>/<last run + 1>
    (io_data.py:193-213).

    Unlike the reference (single-threaded, returns without creating), the
    directory is CLAIMED here with an exclusive mkdir under a lock so
    concurrent --parallel-videos debug runs sharing an export parent cannot
    compute the same run id and interleave their CSVs.  (max(..., default=0)
    also hardens the reference's latent max([]) crash on an empty date
    directory.)"""
    with _test_dir_lock:
        date_dir = Path(parent_dir) / str(date.today())
        run_ids = [int(Path(p).stem) for p in glob(str(date_dir / "*/"))]
        nxt = max(run_ids, default=0) + 1
        while True:
            candidate = date_dir / str(nxt)
            try:
                candidate.mkdir(parents=True, exist_ok=False)
                return candidate
            except FileExistsError:  # raced by another process
                nxt += 1


# The reference's research helpers (io_data.py:143-190): DataFrame <-> CSV
# round trips that turn list-of-pair columns (centroid paths) back from
# their string form.  The accuracy corpus scores CSVs with them.


def dataframe_to_csv(dataframe, output_filepath: Path) -> None:
    """Write a DataFrame as CSV, making its parent directories
    (io_data.py:143-149)."""
    output_filepath = Path(output_filepath)
    output_filepath.parent.mkdir(parents=True, exist_ok=True)
    dataframe.to_csv(str(output_filepath))


def dataframe_from_csv(filepath):
    """A results or ground-truth CSV as a DataFrame indexed by
    (microsecond-rounded timestamp, framenumber), a centroid column parsed
    back to float pairs (io_data.py:152-164)."""
    import pandas as pd

    df = pd.read_csv(filepath)
    df["timestamp"] = pd.to_datetime(df["timestamp"]).dt.round(freq="us")
    df.set_index(["timestamp", "framenumber"], inplace=True)
    if "centroid" in df:
        df = list_to_float(df, "centroid")
    return df


def list_to_float(dataframe, column: str):
    """Parse a column of "[(y, x), (y, x), ...]" strings into lists of
    [y, x] float pairs (io_data.py:167-190)."""

    def parse(full_string: str):
        condensed = full_string.replace(" ", "").replace("[", "").replace("]", "")
        pairs = condensed.strip("()").split("),(")
        return [[float(v) for v in p.split(",")] for p in pairs]

    dataframe[column] = dataframe.apply(lambda row: parse(row[column]), axis=1)
    return dataframe
