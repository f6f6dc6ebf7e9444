"""Two scenes of tools/torch_resume_fuzz.py, the port's randomized
checkpoint/resume gate: one on the device tracker and one on the host
tracker, each cut at a random frame and resumed, equal to the full run."""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


def test_torch_resume_fuzz_campaign_smoke(tmp_path):
    import torch_resume_fuzz

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "rf_smoke.json"
        summary = torch_resume_fuzz.run_campaign(scenes=2, campaign_seed=20260820, out=str(out))
    finally:
        torch.set_num_threads(threads)
    assert summary["mismatches"] == 0 and summary["scenes"] == 2
    assert all(r["checkpoint_written"] for r in summary["results"])
    assert [r["tracker"] for r in summary["results"]] == ["device", "host"]
    assert json.loads(out.read_text())["mismatches"] == 0
