"""Small-N smoke of the port's rpca_fixed_iters counts campaign
(tools/torch_rpca_fixed_counts.py), as tests/test_rpca_fixed_counts_smoke.py
is of the JAX side's: two scenes (one device-tracker, one host) through the
whole campaign, zero count divergences between dynamic stopping and the
fixed-trip option, and the file rewritten after every scene."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_torch_rpca_fixed_counts_campaign_smoke(tmp_path):
    import torch_rpca_fixed_counts

    out = tmp_path / "rfc_smoke.json"
    summary = torch_rpca_fixed_counts.run_campaign(
        scenes=2, fixed_iters=15, campaign_seed=20260820, out=str(out),
        device=torch.device("cpu"))
    assert summary["mismatches"] == 0
    assert summary["scenes"] == 2
    assert {r["tracker"] for r in summary["results"]} == {"device", "host"}
    on_disk = json.loads(out.read_text())
    assert on_disk["mismatches"] == 0
    assert len(on_disk["results"]) == 2


def test_torch_rpca_window_iters_campaign_smoke(tmp_path):
    """--window-iters on one scene on the CPU, where the shipped route is
    the plain chain: the same iterations and counts, f64's beside them, and
    the refined eigh and the route of ops/ialm_trip.py put back afterwards."""
    import torch_rpca_fixed_counts

    from swiftwatcher_tpu_torch.ops import ialm_trip
    from swiftwatcher_tpu_torch.ops.refined_eigh import refined_eigh

    out = tmp_path / "rwi_smoke.json"
    route = ialm_trip.kernel_route
    summary = torch_rpca_fixed_counts.window_iters_campaign(
        scenes=1, campaign_seed=20260820, out=str(out), device=torch.device("cpu"))
    (row,) = summary["results"]
    assert summary["mismatches"] == 0 and row["ok"]
    assert row["iters"]["shipped"] == row["iters"]["plain"]
    assert row["counts"]["shipped"] == row["counts"]["plain"]
    assert len(row["iters"]["f64"]) == len(row["iters"]["plain"]) > 0
    assert row["partial_last"] == (row["n_frames"] % 21 != 0)
    windows = len(row["iters"]["plain"])
    assert sum(summary["windows_by_gap"]["shipped_full"].values()) + sum(
        summary["windows_by_gap"]["shipped_partial"].values()) == windows
    assert ialm_trip.refined_eigh is refined_eigh
    assert ialm_trip.kernel_route is route
    assert json.loads(out.read_text())["results"] == summary["results"]
