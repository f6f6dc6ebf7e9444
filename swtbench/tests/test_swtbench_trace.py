"""The trace's reduction on a hand-made Chrome trace."""

import pytest

from swtbench.trace import TraceSummary


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_ranges_busy_and_idle():
    events = [
        _x("user_annotation", "localize_dispatch", 0, 75),
        _x("user_annotation", "swt_fused_motion", 40, 9),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=3),
        _x("user_annotation", "consume", 140, 60),
        _x("kernel", "gemm", 20, 30, tid=7, correlation=1),
        _x("kernel", "k1", 60, 10, tid=7, correlation=2),
        _x("gpu_memcpy", "copy", 70, 10, tid=7),
        _x("kernel", "gemm", 160, 20, tid=7, correlation=3),
    ]
    s = TraceSummary.from_events(events, 200e-6)
    assert s.busy_s == pytest.approx(70e-6)           # 20-50, 60-80, 160-180
    assert s.range_kernel_s == pytest.approx(
        {"localize_dispatch": 40e-6, "swt_fused_motion": 10e-6, "consume": 20e-6})
    assert s.range_count == {"localize_dispatch": 1, "swt_fused_motion": 1, "consume": 1}
    assert s.device_ops[0] == ["gemm", pytest.approx(50e-6)]
    # a gap goes by the range at its start: 0-20 and 50-60 to
    # localize_dispatch, 80-160 to none, 180-200 to consume
    assert dict(s.idle_gaps) == pytest.approx(
        {"localize_dispatch": 30e-6, "prefetch_wait_or_other": 80e-6, "consume": 20e-6})
