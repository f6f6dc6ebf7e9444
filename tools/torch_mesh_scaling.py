#!/usr/bin/env python
"""Scaling of the port's sharded localisation path over mesh sizes.

Counterpart of tools/mesh_scaling.py for swiftwatcher_tpu_torch.  Runs
`parallel/mesh.py:sharded_localize_windows_gray` on (d, 1) meshes (windows
split over 'data', a FIXED per-rank window batch, so the total work grows
with d) and on (1, m) meshes (the RPCA pixel axis split over 'model', a
FIXED total batch), each beside the unsharded `localize_windows_gray` on
the same batch, at H = 64, W = 128.  Each point is the median of
--repeats timed runs of --iters calls (ending in a synchronize on a
card), with the samples and their spread.

Each rank past the first is a worker process (parallel/mesh.py): NCCL
where every rank has a card of its own, gloo where ranks share a card or
run on the CPU.  The `substrate` string and `mesh_backends` say what ran.
Ranks that share one card (or one CPU) cannot run faster together than
one alone: there, flat total windows/s over 'data' says that the sharding
divides the work (a rank recomputing another's windows would divide the
rate by the rank count), and the sharded/unsharded ratio is the cost of
the collectives and the padding.

    python tools/torch_mesh_scaling.py [--sizes 1 2 4] [--per-device-windows 2]
        [--iters 4] [--repeats 5] [--timeout 300] [--device cpu] [--out scaling.json]

Runs on the card unless --device says otherwise.  Writes --out only when
it is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from swiftwatcher_tpu_torch.device import device_from_arg  # noqa: E402
from swiftwatcher_tpu_torch.parallel.mesh import (  # noqa: E402
    DEFAULT_TIMEOUT,
    make_mesh,
    sharded_localize_windows_gray,
)
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray  # noqa: E402


def _median_time(fn, repeats):
    """Median wall-clock of `fn()` over `repeats` runs, the raw samples and
    their (max - min) / median spread: a single sample on a shared host
    times the scheduler as much as the program."""
    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        dts.append(time.perf_counter() - t0)
    med = sorted(dts)[len(dts) // 2]
    spread = (max(dts) - min(dts)) / med if med else 0.0
    return med, [round(d, 3) for d in dts], round(spread, 3)


def _windows(rng, B, T, H, W):
    """(B, T, H, W) u8: a noisy flat background with a moving dark blob per
    window, so IALM does real work (tools/mesh_scaling.py's batch)."""
    base = rng.integers(90, 170, size=(H, W), dtype=np.uint8)
    gray = base[None, None].astype(np.int16) + rng.integers(-2, 3, size=(B, T, H, W))
    for b in range(B):
        s = 2 + (3 * b) % 10
        gray[b, 5:15, s:s + 5, 8:14] -= 90
    return gray.clip(0, 255).astype(np.uint8)


def _runner(localize, gray, k, device):
    """k calls of localize(gray), each table read (its area summed, as the
    tracker would read it), ending in a synchronize on a card."""
    def run():
        total = 0
        for _ in range(k):
            table, it = localize(gray)
            total += int(table.area.sum()) + int(it.sum())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return total
    return run


def _timed(localize, gray, iters, repeats, device):
    """One untimed call, then _median_time of `repeats` runs of `iters`
    calls."""
    _runner(localize, gray, 1, device)()
    return _median_time(_runner(localize, gray, iters, device), repeats)


def measure(data_sizes, per_dev_windows, iters, repeats, backends: dict, H=64, W=128, *,
            device=torch.device("cuda"), timeout=DEFAULT_TIMEOUT):
    """The 'data' sweep: per mesh size d, d * per_dev_windows windows on a
    (d, 1) mesh against the unsharded path on the same batch.  `backends`
    gets each mesh's process-group backend."""
    cfg = DEFAULT_CONFIG
    T = cfg.window_size
    rng = np.random.default_rng(0)
    results = []
    for data in data_sizes:
        B = per_dev_windows * data
        gray = torch.from_numpy(_windows(rng, B, T, H, W)).to(device)
        mesh = make_mesh((data, 1), device=device, timeout=timeout)
        try:
            backends[f"data={data}"] = mesh.backend
            dt, dts, spread = _timed(lambda g: sharded_localize_windows_gray(g, mesh, cfg),
                                     gray, iters, repeats, device)
        finally:
            mesh.close()
        dt_un, dts_un, _ = _timed(lambda g: localize_windows_gray(g, cfg), gray, iters,
                                  repeats, device)
        wps = iters * B / dt
        results.append({
            "data_devices": data,
            "windows_per_device": per_dev_windows,
            "windows_per_sec": round(wps, 2),
            "frames_per_sec": round(wps * T, 2),
            "elapsed_s": round(dt, 3),
            "elapsed_samples_s": dts,
            "spread_pct": round(100 * spread, 1),
            "unsharded_same_batch_s": round(dt_un, 3),
            "unsharded_samples_s": dts_un,
            "sharded_overhead_x": round(dt / dt_un, 3),
        })
        print(f"data={data}: {wps:.2f} windows/s ({wps * T:.1f} frames/s), "
              f"overhead vs unsharded {dt / dt_un:.2f}x", flush=True)
    return results


def measure_model(model_sizes, B, iters, repeats, backends: dict, H=64, W=128, *,
                  device=torch.device("cuda"), timeout=DEFAULT_TIMEOUT):
    """The 'model' sweep at a FIXED total batch of B windows: the RPCA pixel
    axis split over m ranks on a (1, m) mesh (the T x T Grams and norms
    summed over 'model', the motion image gathered), against the unsharded
    path on the same batch."""
    cfg = DEFAULT_CONFIG
    T = cfg.window_size
    rng = np.random.default_rng(1)
    gray = torch.from_numpy(_windows(rng, B, T, H, W)).to(device)
    dt_un, _, _ = _timed(lambda g: localize_windows_gray(g, cfg), gray, iters, repeats, device)

    results = []
    for m in model_sizes:
        mesh = make_mesh((1, m), device=device, timeout=timeout)
        try:
            backends[f"model={m}"] = mesh.backend
            dt, dts, spread = _timed(lambda g: sharded_localize_windows_gray(g, mesh, cfg),
                                     gray, iters, repeats, device)
        finally:
            mesh.close()
        results.append({
            "model_devices": m,
            "total_windows": B,
            "elapsed_s": round(dt, 3),
            "elapsed_samples_s": dts,
            "spread_pct": round(100 * spread, 1),
            "unsharded_same_batch_s": round(dt_un, 3),
            "sharded_overhead_x": round(dt / dt_un, 3),
        })
        print(f"model={m}: {iters * B / dt:.2f} windows/s, overhead vs unsharded "
              f"{dt / dt_un:.2f}x", flush=True)
    return results


def substrate(device, backends) -> str:
    """What ran: the ranks, the card (or the CPU) they share or own, and
    each mesh size's backend."""
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        where = f"{torch.cuda.get_device_name(device)} ({cards} card{'s' * (cards > 1)} present)"
    else:
        where = "the CPU"
    by_size = {}
    for name, backend in backends.items():
        by_size.setdefault(int(name.split("=")[1]), set()).add(backend)
    return "; ".join(f"{n} rank{'s' * (n > 1)} on {where}, {'/'.join(sorted(by_size[n]))}"
                     for n in sorted(by_size))


def scaling(sizes, per_device_windows=2, iters=4, repeats=5, *, device=torch.device("cuda"),
            timeout=DEFAULT_TIMEOUT) -> dict:
    """Both sweeps over `sizes`: the JSON object main prints (and writes)."""
    backends = {}
    results = measure(sizes, per_device_windows, iters, repeats, backends, device=device,
                      timeout=timeout)
    base = results[0]["windows_per_sec"]
    for r in results:
        # on a shared card or CPU, flat TOTAL throughput = work divided
        # cleanly; well below 1 would flag replicated windows
        r["total_throughput_vs_1dev"] = round(r["windows_per_sec"] / base, 3)
    model_results = measure_model(sizes, 8, iters, repeats, backends, device=device,
                                  timeout=timeout)
    return {
        "substrate": substrate(device, backends),
        "backend": device.type,
        "mesh_backends": backends,
        "per_device_windows": per_device_windows,
        "repeats_per_point": repeats,
        "iters_per_sample": iters,
        "timing": "median of repeats_per_point runs per point, each of iters_per_sample "
                  "calls ending in a synchronize on a card; elapsed_samples_s carries the "
                  "raw samples and spread_pct their max-min range",
        "results": results,
        "model_axis_results": model_results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4],
                    help="mesh sizes: (d, 1) meshes for the 'data' sweep, (1, m) for 'model'")
    ap.add_argument("--per-device-windows", type=int, default=2)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repetitions per point; the MEDIAN is reported")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                    help="seconds a mesh's start, run or collective may take")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    out = scaling(args.sizes, args.per_device_windows, args.iters, args.repeats,
                  device=device, timeout=args.timeout)
    blob = json.dumps(out, indent=2)
    print(blob)
    if args.out:
        args.out.write_text(blob + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
