"""The committed classify-1080p configuration and its cell, classify.swarm:
count-1080p with the segment filter and nothing else changed, correct on
the CPU at the tiny size, and the three readers of the filter's layers on
hand-made runs (a number where their input is there, None where it is not:
no trace, no crops, or a program without the forward's range)."""

import pytest

from swtbench import roofline, run, spec
from swtbench.trace import TraceSummary

CELL = "classify.swarm"
READERS = ["classify_roofline", "classify.device_ms_per_batch", "classify.host_ms_per_batch"]


def test_the_configuration_is_count_1080p_with_the_filter():
    conf = spec.load_cell(CELL).config
    count = spec.load_cell("count.swarm").config
    assert conf["segment_filter"] == {
        "kind": "squeezenet", "weights": "swiftwatcher_tpu_torch/models/segment_classifier.npz"}
    assert (spec.ROOT / conf["segment_filter"]["weights"]).is_file()
    for key in ("frame", "corners", "crop", "tracker_impl"):
        assert conf[key] == count[key], key
    added = {k: v for k, v in conf["pipeline"].items() if k not in count["pipeline"]}
    assert {k: v for k, v in conf["pipeline"].items() if k in count["pipeline"]} == \
        count["pipeline"]
    assert added == {"min_seg_size": [24, 24], "cnn_input_size": 224, "cnn_resize_to": 24,
                     "cnn_mean": [0.485, 0.456, 0.406], "cnn_std": [0.229, 0.224, 0.225],
                     "classify_fused": True}
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == "classify-1080p")
    assert entry["reduced"] == [] and entry["file"] == "swtbench/configs/classify-1080p.json"


def test_the_cell_checks_the_logits_and_keeps():
    cell = spec.load_cell(CELL)
    assert cell.traffic == spec.load_cell("count.swarm").traffic
    assert cell.limits == dict(spec.load_cell("count.swarm").limits, logit_gap=1e-3,
                               keep_off_pct=0.0)
    assert set(READERS) <= {m.name for m in cell.per_layer}


def test_the_committed_cell_is_correct_on_the_cpu(tiny):
    result, notes = run.run_cell(spec.load_cell(CELL), 2**31 + 23, 2.0, True, "cpu",
                                 shrink=tiny)
    assert result["correct"], notes
    checks = result["checks"]
    assert checks["keep_off_pct"]["value"] == 0.0 and checks["logit_gap"]["value"] < 1e-4
    # the host's readers read the filter's spans; no kernel runs on the CPU
    assert result["metrics"]["classify.host_ms_per_batch"]["value"] > 0
    assert "classify_roofline" not in result["metrics"]
    assert any(n.startswith("classify crops") for n in notes)


def _record(stage_seconds=None, trace=None, crops=None, traced_crops=None, host_batches=4):
    cfg = run.program_config(spec.load_cell(CELL).config["pipeline"])
    return spec.RunRecord(
        setup_s=1.0, window_s=2.0, frames_in_window=100, host_s=1.0, host_frames=50,
        host_batches=host_batches, stage_seconds=dict(stage_seconds or {}), cpu_s=0.5,
        slow_path_frames=0, ialm_iters=[], traced_iters=[], windows_per_batch=2,
        window_frames=21, crop_hw=(216, 432), stabilize=False, cfg=cfg, trace=trace,
        crops=crops, traced_crops=traced_crops)


def _trace(kernel_s, count):
    return TraceSummary(window_s=1.0, busy_s=0.5, range_kernel_s=kernel_s, range_count=count,
                        device_ops=[], idle_gaps=[])


TRACE = _trace({"classify_track_fused": 0.375, "classify_forward": 0.3},
               {"classify_track_fused": 3, "classify_forward": 3})


def test_the_readers_on_a_hand_made_run():
    rec = _record({"classify_crop": 0.2, "classify_pack": 0.12, "consume": 0.5},
                  trace=TRACE, crops=4000, traced_crops=3000)
    n_bytes, ops = roofline.squeezenet_forward(3000, 224)
    assert spec.load_reader("classify_roofline")(rec) == pytest.approx(
        100.0 * max(n_bytes / 3.35e12, ops / 67e12) / 0.3)
    assert spec.load_reader("classify_roofline")(rec) == pytest.approx(
        100.0 * 3000 * 1.465e9 / 67e12 / 0.3, rel=1e-3)
    assert spec.load_reader("classify.device_ms_per_batch")(rec) == pytest.approx(125.0)
    assert spec.load_reader("classify.host_ms_per_batch")(rec) == pytest.approx(80.0)


@pytest.mark.parametrize("name", READERS)
def test_none_where_there_is_nothing_to_read(name):
    read = spec.load_reader(name)
    spans = {"classify_crop": 0.2, "classify_pack": 0.12}
    # a configuration without the filter: no crops, no classify spans or ranges
    assert read(_record(trace=_trace({"localize_dispatch": 0.9},
                                     {"localize_dispatch": 3}))) is None
    # a filter that met no segment
    assert read(_record(spans, trace=TRACE, crops=0, traced_crops=0)) is None
    if name != "classify.host_ms_per_batch":
        # an untraced run
        assert read(_record(spans, crops=4000, traced_crops=3000)) is None


def test_the_parent_program_has_no_forward_range():
    """The parent books classify_track_fused but no classify_forward: the
    roofline falls silent and raises nothing."""
    parent = _trace({"classify_track_fused": 0.375}, {"classify_track_fused": 3})
    rec = _record({"classify_crop": 0.2}, trace=parent, crops=4000, traced_crops=3000)
    assert spec.load_reader("classify_roofline")(rec) is None
    assert spec.load_reader("classify.device_ms_per_batch")(rec) == pytest.approx(125.0)
