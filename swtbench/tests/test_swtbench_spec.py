"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

import json
import re

import pytest

from swtbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["swtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"] == f"swtbench/configs/{c['name']}.json"
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in configs
        used.add(w["config"])
        cell = spec.load_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert set(m) <= METRIC_KEYS | {"bound"}
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= METRIC_KEYS | {"layer", "moves"}
            assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in e2e


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
