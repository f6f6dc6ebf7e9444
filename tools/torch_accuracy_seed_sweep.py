#!/usr/bin/env python
"""Seed-robustness sweep of the opt-in accuracy extensions, through the
PyTorch port.

Counterpart of tools/accuracy_seed_sweep.py for swiftwatcher_tpu_torch.
The corpus (tools/torch_accuracy_corpus.py) scores each scene at ONE seed,
which leaves open whether the extensions are tuned to those draws.  This
sweep renders the adversarial scenes at fresh seeds and scores the
reference defaults against the accuracy_pack overrides on every draw, so
the claimed improvement is a distribution: means, per-seed wins, losses
and ties, and the worst regression over all draws.

    python tools/torch_accuracy_seed_sweep.py --seeds 3 --scenes crowded jitter2 --json -
    python tools/torch_accuracy_seed_sweep.py --round 6   # -> torch_accuracy_seeds_r06.json

Scenes and scoring are torch_accuracy_corpus.py's (second granularity by
default); seeds are BASE_SEED_OFFSET + 100 i + crc32(name) % 97, as the
JAX-side sweep draws them, so that no sweep seed collides with the pinned
corpus seeds (40-57).  Runs on the card unless --device says otherwise.
--json writes the result to a path ('-' for stdout); --round N writes it
to torch_accuracy_seeds_rNN.json at the repo root, a name no committed
artifact has.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from swiftwatcher_tpu_torch.device import device_from_arg  # noqa: E402
from torch_accuracy_corpus import SCENES, VARIANTS, run_scene  # noqa: E402

# Scenes where the pack claims a win or must not regress (controls).
DEFAULT_SCENES = ("clean", "crowded", "crowded_flyby", "occluded_crowd",
                  "jitter2", "flyby_trap")
BASE_SEED_OFFSET = 1000  # disjoint from the pinned corpus seeds
KINDS = ("detection", "detection+classification")


def scene_seed(name: str, i: int) -> int:
    # crc32, not hash(): PYTHONHASHSEED would make reruns diverge
    return BASE_SEED_OFFSET + 100 * i + zlib.crc32(name.encode()) % 97


def sweep(names, seeds: int, granularity: str, device) -> dict:
    """Base vs accuracy_pack on `seeds` fresh draws of each scene: the JSON
    object main writes."""
    overrides = VARIANTS["accuracy_pack"]["overrides"]
    out = {
        "granularity": granularity,
        "seeds_per_scene": seeds,
        "overrides": overrides,
        "device": str(device),
        "scenes": {},
    }
    for name in names:
        spec = dict(SCENES[name])
        rows = []
        for i in range(seeds):
            spec["seed"] = scene_seed(name, i)
            with tempfile.TemporaryDirectory() as td:
                base = run_scene(name, spec, Path(td) / "base", granularity, device)
                pack = run_scene(name, spec, Path(td) / "pack", granularity, device,
                                 overrides=overrides)
            if base is None or pack is None:
                # run_scene's only None: a container scene with no H.264
                # writer on this host, unusable for every seed
                print(f"{name}: skipped (no H.264 encoder on this host)", file=sys.stderr)
                rows = []
                break
            row = {"seed": spec["seed"]}
            for kind in KINDS:
                b, p = base["scores"][kind], pack["scores"][kind]
                row[kind] = {"base_f1": round(b.f1, 4), "pack_f1": round(p.f1, 4)}
            rows.append(row)
            print(f"{name:<16} seed {spec['seed']:<6} det "
                  f"{row['detection']['base_f1']:.4f} -> {row['detection']['pack_f1']:.4f}   "
                  f"det+class {row[KINDS[1]]['base_f1']:.4f} -> {row[KINDS[1]]['pack_f1']:.4f}",
                  file=sys.stderr)
        if not rows:
            out["scenes"][name] = {"skipped": "no H.264 encoder on this host"}
            continue
        scene = {"seeds": rows}
        for kind in KINDS:
            b = np.array([r[kind]["base_f1"] for r in rows])
            p = np.array([r[kind]["pack_f1"] for r in rows])
            scene[kind] = {
                "base_mean_f1": round(float(b.mean()), 4),
                "pack_mean_f1": round(float(p.mean()), 4),
                "wins": int((p > b).sum()),
                "losses": int((p < b).sum()),
                "ties": int((p == b).sum()),
                "worst_delta": round(float((p - b).min()), 4),
            }
        out["scenes"][name] = scene

    for kind in KINDS:
        rows = [s[kind] for s in out["scenes"].values() if kind in s]
        if not rows:
            continue
        out.setdefault("AVG", {})[kind] = {
            "base_mean_f1": round(float(np.mean([r["base_mean_f1"] for r in rows])), 4),
            "pack_mean_f1": round(float(np.mean([r["pack_mean_f1"] for r in rows])), 4),
            "total_wins": sum(r["wins"] for r in rows),
            "total_losses": sum(r["losses"] for r in rows),
            "total_ties": sum(r["ties"] for r in rows),
            "worst_delta": round(min(r["worst_delta"] for r in rows), 4),
        }
        a = out["AVG"][kind]
        print(f"AVG {kind:<28} base {a['base_mean_f1']:.4f} -> pack {a['pack_mean_f1']:.4f}  "
              f"(w/l/t {a['total_wins']}/{a['total_losses']}/{a['total_ties']}, worst "
              f"{a['worst_delta']:+.4f})", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--round", type=int, default=None,
                    help="write torch_accuracy_seeds_r{NN}.json at the repo root")
    ap.add_argument("--json", default=None, help="output path ('-' for stdout)")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--scenes", nargs="*", default=None)
    # the corpus's scoring bins ("frame", offered by the JAX-side sweep, is
    # not one of its evaluate.py's and raises there)
    ap.add_argument("--granularity", default="second",
                    choices=("exact", "second", "minute", "video"))
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.json is None and args.round is None:
        ap.error("give --json PATH (or -) or --round N")
    names = args.scenes or DEFAULT_SCENES
    unknown = [n for n in names if n not in SCENES]
    if unknown:
        ap.error(f"unknown scenes {unknown}; have {list(SCENES)}")
    device = device_from_arg(args.device)

    blob = json.dumps(sweep(names, args.seeds, args.granularity, device), indent=2)
    if args.json == "-":
        print(blob)
    else:
        path = (Path(args.json) if args.json else Path(__file__).resolve().parent.parent
                / f"torch_accuracy_seeds_r{args.round:02d}.json")
        path.write_text(blob + "\n")
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
