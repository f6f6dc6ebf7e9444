"""What BENCHMARK.json and the files beside it say about a cell.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by its name:

  swtbench/configs/<config>.json   the configuration as it is run
  swtbench/traffic/<traffic>.json  the traffic's parameters (traffic.py)
  swtbench/metrics/<metric>.py     the metric's reader: read(run) -> float or None
  swtbench/checks/<cell>.json      the limit of each number `correct` compares
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(name: str) -> Callable:
    """read() of swtbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"swtbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics(entries, cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], load_reader(m["name"])) for m in entries
            if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell `name` of BENCHMARK.json (at the root of the checkout)."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    return Cell(
        name=name,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=load_json(HERE / "checks" / f"{name}.json"),
        end_to_end=_metrics(bench["end_to_end"], name),
        per_layer=_metrics(bench["per_layer"], name),
    )


@dataclasses.dataclass
class RunRecord:
    """What one run hands each metric's reader.

    The window runs from the timed call's first completed batch to its last
    completed batch before `seconds` had passed.  The host's numbers
    (stage seconds, CPU, counters) cover the host part of the window: all
    of it in an untraced run, its first half in a traced one, whose
    profiler runs over the rest."""

    setup_s: float              # process start -> the window's opening
    window_s: float             # the window's length, host clock
    frames_in_window: int       # frames of the batches completed in it
    host_s: float               # the host part's length, host clock
    host_frames: int            # frames of the batches completed in the host part
    host_batches: int           # batches completed in the host part
    stage_seconds: Dict[str, float]  # RunMetrics.stage_seconds over the host part
    cpu_s: float                # the process's CPU seconds (all threads) in the host part
    slow_path_frames: Optional[int]  # frames the CCL slow path took in the host part
    ialm_iters: List[int]       # IALM iterations of the host part's windows
    traced_iters: List[int]     # IALM iterations of the windows dispatched while traced
    windows_per_batch: int
    window_frames: int
    crop_hw: tuple
    stabilize: bool
    cfg: object                 # the program's resolved configuration
    trace: object = None        # trace.TraceSummary of the traced part (--trace 1)
    # RunMetrics.counters over the host part: how many times each span ran
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # crops the segment filter classified in the host part's batches, and
    # in the batches it classified while traced (None without a filter)
    crops: Optional[int] = None
    traced_crops: Optional[int] = None
