"""Each cell end to end at a tiny size on the CPU, and on the card."""

import json
import subprocess
import sys

import pytest

from swtbench import run, spec

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(name, trace, tiny):
    cell = spec.load_cell(name)
    result, notes = run.run_cell(cell, 2**31 + 11, 2.0, trace, "cpu", shrink=tiny)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0, notes
    assert set(result["checks"]) == set(cell.limits) | {"frames_not_processed"}
    assert notes[-1].startswith("check frames_not_processed")
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m.name: m.unit for m in wanted}
    for k, v in result["metrics"].items():
        assert units[k] == v["unit"]
    if trace:
        # no device trace on the CPU: the device metrics stay out
        assert "device.idle_pct" not in result["metrics"]
        assert "rpca.iters_per_window" in result["metrics"]
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
        assert result["metrics"]["setup_s"]["value"] > 0


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    code = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    out = subprocess.run([sys.executable, "-m", "swtbench.run", "--workload", name,
                          "--seed", "5", "--seconds", "4", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
