#!/usr/bin/env python
"""Ground-truth accuracy evaluation through the PyTorch port.

Counterpart of tools/evaluate.py: the reference report's §4.2 workflow
(precision, recall and F1, and TP/FP/missed scoring of per-video counts
against human-annotated ground truth), with the same arguments and the
same output.  It reads CSVs with the port's io/export.py and imports no
JAX and nothing of the JAX package; tools/torch_accuracy_corpus.py scores
its scenes with the functions here.

    python tools/torch_evaluate.py --results <dir-or-csv> --groundtruth <csv> \
        [--granularity exact|second|minute|video] [--name "June 13"] [--json]

    python tools/torch_evaluate.py --pairs results1:gt1 results2:gt2 ...   # AVG row

results:      a results CSV as the counter writes it (columns timestamp,
              framenumber, predicted, rejected), or a directory holding
              "*-swifts_full_usec.csv".
ground truth: a CSV that io/export.py:dataframe_from_csv loads, with a
              per-frame count of true chimney entries in a column
              "predicted", "count" or "events".

Counts are summed into time bins; in each bin TP = min(predicted, actual),
FP = max(predicted - actual, 0), missed = max(actual - predicted, 0).
"detection" scores predicted + rejected events (every tracked event, the
report's Table 3); "detection+classification" predicted events only
(Tables 4 and 6).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from swiftwatcher_tpu_torch.io.export import dataframe_from_csv  # noqa: E402


@dataclasses.dataclass
class Score:
    tp: int
    fp: int
    missed: int

    @property
    def actual(self) -> int:
        return self.tp + self.missed

    @property
    def predicted(self) -> int:
        return self.tp + self.fp

    @property
    def precision(self) -> float:
        return self.tp / self.predicted if self.predicted else 0.0

    @property
    def recall(self) -> float:
        return self.tp / self.actual if self.actual else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0


GT_COLUMNS = ("predicted", "count", "events")


def _count_series(df, columns, granularity: str):
    """Per-bin event counts of a timestamp-indexed frame (the sum of the
    requested columns), at the requested granularity."""
    present = [c for c in columns if c in df.columns]
    if not present:
        raise ValueError(f"none of {columns} present in CSV columns {list(df.columns)}")
    s = df[present].fillna(0).astype(float).sum(axis=1)
    stamps = s.index.get_level_values("timestamp")
    if granularity == "video":
        key = np.zeros(len(s), np.int64)
    elif granularity == "minute":
        key = stamps.floor("min")
    elif granularity == "second":
        key = stamps.floor("s")
    elif granularity == "exact":
        key = stamps
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    return s.groupby(key).sum()


def score_counts(predicted, actual) -> Score:
    """Bin-wise TP/FP/missed between two per-bin count series."""
    import pandas as pd

    joined = pd.concat({"pred": predicted, "act": actual}, axis=1).fillna(0)
    tp = np.minimum(joined["pred"], joined["act"]).sum()
    fp = np.maximum(joined["pred"] - joined["act"], 0).sum()
    missed = np.maximum(joined["act"] - joined["pred"], 0).sum()
    return Score(tp=int(tp), fp=int(fp), missed=int(missed))


def load_results(path: Path):
    """A results CSV, or the full_usec CSV inside a results directory."""
    path = Path(path)
    if path.is_dir():
        hits = sorted(glob.glob(str(path / "*-swifts_full_usec.csv")))
        if not hits:
            raise FileNotFoundError(
                f"no *-swifts_full_usec.csv under {path} — run the counter "
                "with an export directory first")
        path = Path(hits[-1])
    return dataframe_from_csv(path)


def load_groundtruth(path: Path):
    return dataframe_from_csv(Path(path))


def _fmt_row(name, s: Score):
    return (f"{name:<28} {s.actual:>6} {s.predicted:>9} {s.tp:>6} {s.fp:>6} "
            f"{s.missed:>6}  {s.precision:>9.4f} {s.recall:>7.4f} {s.f1:>7.4f}")


def evaluate_pair(results_path: Path, gt_path: Path, granularity: str = "second") -> dict:
    """Detection-only and detection+classification scores for one video."""
    res = load_results(results_path)
    actual = _count_series(load_groundtruth(gt_path), GT_COLUMNS, granularity)
    return {
        "detection": score_counts(
            _count_series(res, ("predicted", "rejected"), granularity), actual),
        "detection+classification": score_counts(
            _count_series(res, ("predicted",), granularity), actual),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", type=Path, help="results CSV or export dir")
    ap.add_argument("--groundtruth", type=Path, help="ground-truth CSV")
    ap.add_argument("--pairs", nargs="*", default=None, metavar="RESULTS:GT[:NAME]",
                    help="multiple videos; adds the report's AVG row")
    ap.add_argument("--granularity", default="second",
                    choices=("exact", "second", "minute", "video"),
                    help="time bin for count matching (default: second; the report's "
                    "tables aggregate per video)")
    ap.add_argument("--name", default=None, help="video label for the table")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    pairs = []
    if args.pairs:
        for spec in args.pairs:
            parts = spec.split(":")
            if len(parts) == 2:
                r, g = parts
                name = Path(r).stem
            elif len(parts) == 3:
                r, g, name = parts
            else:
                ap.error(f"bad --pairs entry {spec!r} (RESULTS:GT[:NAME])")
            pairs.append((Path(r), Path(g), name))
    elif args.results and args.groundtruth:
        pairs.append((args.results, args.groundtruth, args.name or args.results.stem))
    else:
        ap.error("need --results + --groundtruth, or --pairs")

    rows = [(name, evaluate_pair(r, g, args.granularity)) for r, g, name in pairs]
    kinds = ("detection", "detection+classification")

    if args.json:
        out = {
            name: {kind: dict(tp=s.tp, fp=s.fp, missed=s.missed, actual=s.actual,
                              predicted=s.predicted, precision=s.precision,
                              recall=s.recall, f1=s.f1)
                   for kind, s in scores.items()}
            for name, scores in rows
        }
        if len(rows) > 1:
            out["AVG"] = {
                kind: {m: float(np.mean([getattr(scores[kind], m) for _, scores in rows]))
                       for m in ("precision", "recall", "f1")}
                for kind in kinds
            }
        print(json.dumps(out, indent=2))
        return 0

    for kind in kinds:
        print(f"\n== {kind} (granularity: {args.granularity}) ==")
        print(f"{'video':<28} {'actual':>6} {'predicted':>9} {'TP':>6} "
              f"{'FP':>6} {'missed':>6}  {'precision':>9} {'recall':>7} {'F1':>7}")
        for name, scores in rows:
            print(_fmt_row(name, scores[kind]))
        if len(rows) > 1:
            ps = [scores[kind].precision for _, scores in rows]
            rs = [scores[kind].recall for _, scores in rows]
            fs = [scores[kind].f1 for _, scores in rows]
            print(f"{'AVG':<28} {'':>6} {'':>9} {'':>6} {'':>6} {'':>6}  "
                  f"{np.mean(ps):>9.4f} {np.mean(rs):>7.4f} {np.mean(fs):>7.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
