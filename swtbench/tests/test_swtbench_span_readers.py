"""The readers of the program's spans and counters on hand-made runs: each
gives its number where its input is there, and None where it is not (a
program without the spans, or a cell that bypasses the layer)."""

import pytest

from swtbench import spec
from swtbench.trace import TraceSummary

NEW = ["stabilize.device_ms_per_batch", "rpca.device_ms_per_batch", "rpca.trips_per_batch",
       "host.syncs_per_batch", "host.sync_ms_per_batch", "prefetch.worker_ms_per_batch"]


def _record(stage_seconds=None, iters=(), trace=None, host_batches=4):
    return spec.RunRecord(
        setup_s=1.0, window_s=2.0, frames_in_window=100, host_s=1.0, host_frames=50,
        host_batches=host_batches, stage_seconds=dict(stage_seconds or {}), cpu_s=0.5,
        slow_path_frames=0, ialm_iters=list(iters), traced_iters=[], windows_per_batch=2,
        window_frames=21, crop_hw=(216, 432), stabilize=False, cfg=None, trace=trace)


def _trace(kernel_s, count):
    return TraceSummary(window_s=1.0, busy_s=0.5, range_kernel_s=kernel_s, range_count=count,
                        device_ops=[], idle_gaps=[])


def test_device_readers_divide_by_their_ranges():
    tr = _trace({"localize_dispatch": 0.9, "stabilize": 0.02, "ialm_solve": 0.6},
                {"localize_dispatch": 3, "stabilize": 2, "ialm_solve": 3,
                 "sync.ialm_stop": 51, "sync.ialm_eigh": 51, "sync.ccl_flag": 3, "consume": 3})
    run = _record(trace=tr)
    assert spec.load_reader("stabilize.device_ms_per_batch")(run) == pytest.approx(10.0)
    assert spec.load_reader("rpca.device_ms_per_batch")(run) == pytest.approx(200.0)
    assert spec.load_reader("host.syncs_per_batch")(run) == pytest.approx(35.0)


def test_trips_are_each_batchs_slowest_window():
    run = _record(iters=[14, 16, 15, 15, 20, 3])
    assert spec.load_reader("rpca.trips_per_batch")(run) == pytest.approx((16 + 15 + 20) / 3)


def test_host_readers_sum_their_spans_over_the_batches():
    run = _record({"localize": 1.6, "sync.ialm_stop": 0.2, "sync.ialm_eigh": 0.1,
                   "sync.consume_iters": 0.02, "prefetch_read": 0.08,
                   "prefetch_upload": 0.004, "prefetch_wait": 0.5})
    assert spec.load_reader("host.sync_ms_per_batch")(run) == pytest.approx(80.0)
    assert spec.load_reader("prefetch.worker_ms_per_batch")(run) == pytest.approx(21.0)


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_spans(name):
    """The parent program books none of these spans: its stage seconds and
    trace ranges are the runner's alone, and no reader raises."""
    parent = _record({"localize": 1.6, "consume": 0.01, "prefetch_wait": 0.5},
                     trace=_trace({"localize_dispatch": 0.9}, {"localize_dispatch": 3}))
    assert spec.load_reader(name)(parent) is None
    assert spec.load_reader(name)(_record(host_batches=0)) is None


def test_stabilisation_is_none_on_a_cell_without_it():
    tr = _trace({"localize_dispatch": 0.9, "ialm_solve": 0.6},
                {"localize_dispatch": 3, "ialm_solve": 3})
    assert spec.load_reader("stabilize.device_ms_per_batch")(_record(trace=tr)) is None
    assert spec.load_reader("rpca.device_ms_per_batch")(_record(trace=tr)) is not None
