"""Two scenes of tools/torch_parity_fuzz.py, the port's randomized parity
gate: each scene runs the port's host and device trackers and the
reference-semantics oracle on the same frames, once as shipped and once
with every batch sent through the delta6 wire codec."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.mark.parametrize("overrides", [(), ("wire_codec=delta6",)], ids=["raw", "delta6"])
def test_torch_parity_fuzz_campaign_smoke(tmp_path, overrides):
    import torch_parity_fuzz

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "pf_smoke.json"
        summary = torch_parity_fuzz.run_campaign(scenes=2, campaign_seed=20260820,
                                                 device=torch.device("cpu"), out=str(out),
                                                 overrides=overrides)
    finally:
        torch.set_num_threads(threads)
    assert summary["mismatches"] == 0 and summary["scenes"] == 2
    assert summary["overrides"] == list(overrides)
    results = json.loads(out.read_text())["results"]
    assert all(r["ok"] and r["trackers_agree"] for r in results)
    # the scenes have events, so the comparison is not vacuous
    assert sum(len(r["oracle"]["fns"]) for r in results) > 0
