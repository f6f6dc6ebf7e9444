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
