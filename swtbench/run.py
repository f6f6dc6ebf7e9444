"""One run of one benchmark cell on the card this process runs on.

    python3 -m swtbench.run --workload count.dusk --seed 7 --seconds 20 --trace 0

Set-up makes the cell's traffic from the seed, loads the port
(swiftwatcher_tpu_torch) and warms it with one short run_video call of two
batches on the cell's shapes.  The timed call is one run_video over the
stream (swtbench/source.py) with the cell's configuration; the window opens
at its first completed batch, the stream stops feeding once `--seconds`
have passed, and the window closes at the last batch completed by then.
With `--trace 1` the per-layer metrics are reported instead of the
end-to-end ones: the host's from the window's first half, the device's
from the benchmark's own profiler over its second half.  While the call
runs, swtbench/probe.py records each batch's segment tables and shifts on
the device.  Once the call has returned and the device memory's peak is
read, the plain reference (swtbench/reference) works out the same stream's
results, and `correct` holds the program's to them (swtbench/compare.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs) and checks.  The last
lines of standard error give each compared number beside its limit.  Exit
codes: 2 without enough cards, 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time

from . import spec

_IMPORTED = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "swiftwatcher_tpu")
# the stream's length when no deadline ends it first
STREAM_CAP_FRAMES = 10_000_000


def process_start() -> float:
    """This process's start on the time.perf_counter() clock (from /proc,
    to 10 ms; else the import of this module)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def pin_caches() -> None:
    """Kernel and build caches in fixed directories inside the checkout."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _override(v) -> str:
    return ",".join(map(str, v)) if isinstance(v, (list, tuple)) else str(v)


def _slow_path_frames():
    """The port's count of frames that took the CCL slow path, or None."""
    ccl = sys.modules.get("swiftwatcher_tpu_torch.ops.ccl")
    fn = getattr(ccl, "label_components", None)
    return getattr(fn, "slow_path_frames", None)


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cell_inputs(cell: spec.Cell, shrink: dict = None):
    """(pipeline parameters, (H, W), corners, traffic parameters, crop
    region) of `cell`.  shrink, for tests on the CPU: {"height", "width",
    "blocks", "batch_windows"} replace the configuration's frame, the
    traffic's blocks and the batch."""
    from . import traffic
    from .reference.localize import regions

    conf = cell.config
    p = dict(conf["pipeline"])
    H, W = conf["frame"]["height"], conf["frame"]["width"]
    corners = [tuple(c) for c in conf["corners"]]
    params = dict(cell.traffic)
    if shrink:
        H, W = shrink["height"], shrink["width"]
        corners = traffic.scene_corners(H, W)
        params["blocks"] = shrink["blocks"]
        p["batch_windows"] = shrink["batch_windows"]
    if corners != [tuple(c) for c in traffic.scene_corners(H, W)]:
        raise ValueError(f"corners {corners} are not the scene's chimney at {H} x {W}")
    crop, _ = regions(corners, p)
    return p, (H, W), corners, params, crop


def program_config(p: dict):
    """The port's PipelineConfig of the parameters `p` (its --set strings)."""
    from swiftwatcher_tpu_torch.config import config_with_overrides

    return config_with_overrides([f"{k}={_override(v)}" for k, v in p.items()])


def program_results(res, probe, n_frames: int) -> dict:
    """What `correct` reads of a run_video result and of what `probe`
    recorded on its way, over the stream's first `n_frames` frames."""
    segments, shifts = probe.frames(n_frames)
    return {"events": [(e.first_centroid, e.last_centroid, e.frame_number) for e in res.events],
            "predicted": res.total_predicted, "rejected": res.total_rejected,
            "iters": list(res.ialm_iters), "segments": segments, "shifts": shifts,
            "logits": probe.segment_logits(n_frames)}


def filter_weights(conf: dict):
    """The .npz of the configuration's segment filter, or None without one."""
    sf = conf.get("segment_filter")
    if sf is None:
        return None
    if sf.get("kind") != "squeezenet":
        raise ValueError(f"unknown segment filter {sf!r}")
    return spec.ROOT / sf["weights"]


def segment_filter(weights, cfg, device):
    """The port's SqueezeNet segment filter of `weights`, or None."""
    if weights is None:
        return None
    from swiftwatcher_tpu_torch.models.classifier import SqueezeNetSegmentFilter

    return SqueezeNetSegmentFilter.from_weights(weights, cfg, device)


def crop_rows(conf: dict, cfg) -> int:
    """Crops a batch can classify at most: every tracked slot (the device
    tracker's max_tracks, the host tracker's 255 labels) of every frame."""
    K = cfg.max_tracks if conf["tracker_impl"] == "device" else 255
    return cfg.batch_windows * cfg.window_size * K


def probe_slots(seconds: float) -> int:
    """Batches the probe sets slots aside for: four a second of the window
    (about 1.6 times the rate of either cell today) and the call's start
    and drain."""
    return int(4 * seconds) + 16


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             shrink: dict = None, started: float = None):
    """(result line, notes for standard error) of one run of `cell`
    (`shrink`: see cell_inputs).

    The window runs from the timed call's first completed batch to its
    last completed batch before `seconds` had passed.  Untraced, the
    host's per-layer numbers cover the whole window.  Traced, they cover
    its first half, up to the first batch completed after half the
    seconds, where the profiler starts; the profiler then traces the rest
    of the window, so that its cost on the host is in no host number."""
    import numpy as np
    import torch

    from . import compare, traffic
    from .probe import Probe
    from .reference import run_reference
    from .source import StreamSource
    from .trace import Tracer
    from swiftwatcher_tpu_torch.pipeline.runner import run_video

    started = process_start() if started is None else started
    t_entry = time.perf_counter()
    device = torch.device(device)
    conf = cell.config
    p, (H, W), corners, params, crop = cell_inputs(cell, shrink)
    cfg = program_config(p)
    B, T = int(p["batch_windows"]), int(p["window_size"])
    tracker = conf["tracker_impl"]

    weights = filter_weights(conf)
    clip = traffic.generate(params, seed, H, W, crop, keep_bgr=weights is not None)
    # a segment filter crops from whole frames: the stream serves them
    frames = None if weights is None else traffic.full_frames(clip)
    h, w = clip.crops.shape[1:]
    if not shrink and [h, w] != [conf["crop"]["height"], conf["crop"]["width"]]:
        raise ValueError(f"the crop is {h} x {w}, the configuration says {conf['crop']}")

    t_traffic = time.perf_counter()
    seg_filter = segment_filter(weights, cfg, device)
    probe = Probe(device, probe_slots(seconds), B, T,
                  crop_rows(conf, cfg) if seg_filter else 0)
    with probe:
        # warm-up: two batches on the cell's shapes, through the probe too
        run_video(StreamSource(clip, 2 * B * T, frames), corners, cfg, device,
                  tracker_impl=tracker, segment_filter=seg_filter)
        tracer = Tracer(device) if trace else None
        if tracer:
            tracer.warm()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        probe.reset()
        t_warm = time.perf_counter()

        source = StreamSource(clip, STREAM_CAP_FRAMES, frames)
        # one mark a completed batch: (time, frames, stage seconds, CPU
        # seconds, slow-path frames, span counts)
        marks = []
        half = []

        def status(done, _total):
            now = time.perf_counter()
            marks.append((now, done, dict(probe.metrics.stage_seconds), _cpu_s(),
                          _slow_path_frames(), dict(probe.metrics.counters)))
            if len(marks) == 1:
                source.deadline = now + seconds
            elif tracer and tracer.prof is None and now >= source.deadline - seconds / 2:
                half.append(len(marks) - 1)
                tracer.start()
            elif tracer and now >= source.deadline:
                tracer.stop()

        res = run_video(source, corners, cfg, device, tracker_impl=tracker, status_cb=status,
                        segment_filter=seg_filter)
    if tracer:
        tracer.stop()
    if len(marks) < 2 or marks[1][0] > source.deadline:
        raise RuntimeError(f"fewer than two batches completed in {seconds} s")
    close = max(i for i, m in enumerate(marks) if m[0] <= source.deadline)
    host = min(half[0], close) if half else close
    gaps = sorted(b[0] - a[0] for a, b in zip(marks[:close], marks[1:close + 1]))
    t_open, f_open, st_open, cpu_open, slow_open, n_open = marks[0]
    t_host, f_host, st_host, cpu_host, slow_host, n_host = marks[host]
    iters = list(res.ialm_iters)
    # batch j holds windows j*B to j*B + B - 1; the batches dispatched
    # while the profiler ran are those after the next one in flight
    traced = iters[(host + 2) * B:(close + 3) * B] if half else []
    # batch j's crops are classified as it is consumed, before mark j:
    # the profiler saw the consumes after mark `host` up to the one after
    # mark `close`
    crops = [probe.crops.get(j, 0) for j in range(len(marks) + 1)]

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = spec.RunRecord(
        setup_s=t_open - started, window_s=marks[close][0] - t_open,
        frames_in_window=marks[close][1] - f_open,
        host_s=t_host - t_open, host_frames=f_host - f_open, host_batches=host,
        stage_seconds={k: v - st_open.get(k, 0.0) for k, v in st_host.items()},
        cpu_s=cpu_host - cpu_open,
        slow_path_frames=None if slow_open is None else slow_host - slow_open,
        ialm_iters=iters[B:(host + 1) * B], traced_iters=traced,
        windows_per_batch=B, window_frames=T, crop_hw=(h, w),
        stabilize=int(p["stabilize_max_shift"]) > 0, cfg=cfg,
        counters={k: v - n_open.get(k, 0) for k, v in n_host.items()},
        crops=sum(crops[1:host + 1]) if seg_filter else None,
        traced_crops=sum(crops[host + 1:close + 2]) if seg_filter and half else None)
    served, read_errors = source.next_frame_number, source.read_errors
    processed = res.frames_processed
    program = program_results(res, probe, source.frames_read)
    by_path = probe.crops_by_path if seg_filter else None
    del res, source, probe, seg_filter
    t_sum = time.perf_counter()
    summary = tracer.summary() if tracer else None
    trace_note = (f"trace stop_s {tracer.stop_s} read_s {time.perf_counter() - t_sum}"
                  if tracer else "trace off")
    record.trace = summary
    del tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = run_reference(clip.first_frame, clip.crops, corners, p, served, device,
                              frames=frames, weights=weights)
    ref_s = time.perf_counter() - t_ref
    failed = served - processed + read_errors
    crop_note = (f"classify crops in the call by path {by_path} compared {len(program['logits'])} "
                 f"host part {record.crops} traced {record.traced_crops}; most segments in a "
                 f"frame (reference) {max(map(len, reference['segments']))}"
                 if by_path else None)
    values = dict(compare.numbers(program, reference), frames_not_processed=float(failed))
    correct, checks = compare.judge(values, {**cell.limits, "frames_not_processed": 0.0})

    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = metric.read(record)
        if value is not None:
            metrics[metric.name] = {"value": float(value), "unit": metric.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(served), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    notes = [
        f"cell {cell.name} seed {seed} trace {int(trace)} card {card_line() if device.type == 'cuda' else 'cpu'}",
        f"setup_s {record.setup_s} window_s {record.window_s} frames_in_window "
        f"{record.frames_in_window} host_s {record.host_s} served {served} "
        f"batches {len(marks)} frames_compared {len(program['segments'])} "
        f"events {len(program['events'])} "
        f"ref_events {len(reference['events'])} predicted {program['predicted']} "
        f"rejected {program['rejected']} reference_s {ref_s}",
        f"setup split, s: start to the cell {t_entry - started} traffic {t_traffic - t_entry} "
        f"probe and warm-up {t_warm - t_traffic} timed call to its first batch {t_open - t_warm}",
        f"iters program mean {float(np.mean(program['iters']))} reference "
        f"{list(map(int, reference['iters']))}",
        "numbers " + json.dumps(values),
    ] + ([crop_note] if crop_note else []) + [
        f"batch seconds in the window: min {gaps[0]} median {gaps[len(gaps) // 2]} "
        f"max {gaps[-1]}; cores {sorted(os.sched_getaffinity(0))}; {trace_note}",
    ] + [f"check {k} {c['value']} limit {c['limit']}" for k, c in checks.items()]
    return result, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    pin_caches()
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), started=started)
    found = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
