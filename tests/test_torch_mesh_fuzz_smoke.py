"""Two scenes of tools/torch_mesh_fuzz.py, the port's randomized mesh gate:
one on a (2, 1) mesh of gloo ranks and one on a (4, 1), each event for
event equal to the unsharded run, and the result file written."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


def test_torch_mesh_fuzz_campaign_smoke(tmp_path):
    import torch_mesh_fuzz

    out = tmp_path / "mf_smoke.json"
    summary = torch_mesh_fuzz.run_campaign(scenes=2, campaign_seed=20260820, out=str(out))
    assert summary["mismatches"] == 0 and summary["scenes"] == 2
    assert [r["mesh"] for r in summary["results"]] == [[2, 1], [4, 1]]
    assert all(r["base"]["events"] or r["base"]["predicted"] == 0
               for r in summary["results"])
    on_disk = json.loads(out.read_text())
    assert on_disk["mismatches"] == 0 and len(on_disk["results"]) == 2
