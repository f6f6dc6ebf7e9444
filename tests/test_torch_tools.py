"""The port's user tools against their JAX-side originals on the same
inputs: tools/torch_evaluate.py vs tools/evaluate.py (the same scoring
JSON and table), tools/torch_extract_frames.py vs tools/extract_frames.py
(the same PNG bytes), tools/torch_export_corners.py vs
tools/export_corners.py (the same attributes.json) and
tools/torch_make_h5_cache.py vs tools/make_h5_cache.py (the same HDF5
datasets and attributes)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swiftwatcher_tpu_torch.io import export
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import evaluate  # noqa: E402
import export_corners  # noqa: E402
import extract_frames  # noqa: E402
import make_h5_cache  # noqa: E402
import torch_evaluate  # noqa: E402
import torch_export_corners  # noqa: E402
import torch_extract_frames  # noqa: E402
import torch_make_h5_cache  # noqa: E402

# a small decode-worker count keeps the parallel backend light under xdist
WORKERS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _few_decode_workers(monkeypatch):
    monkeypatch.setenv("SWTPU_DECODE_WORKERS", str(WORKERS))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The small scene (24 frames) as a .npy clip, an MJPG AVI and an mp4v
    MP4: {kind: path}."""
    d = tmp_path_factory.mktemp("clips")
    frames = make_video(seed=3, n_frames=24, n_entering=1).frames
    np.save(d / "clip.npy", frames)
    out = {"npy": d / "clip.npy"}
    for kind, name, fourcc in (("avi", "clip.avi", "MJPG"), ("mp4", "clip.mp4", "mp4v")):
        assert write_container(d / name, frames, 30.0, fourcc)
        out[kind] = d / name
    return out


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run(capsys, main, argv, *replace):
    """main(argv)'s return code and stdout, each path of `replace` made a
    placeholder."""
    rc = main(argv)
    out = capsys.readouterr().out
    for i, p in enumerate(replace):
        out = out.replace(str(p), f"<{i}>")
    return rc, out


# ---- evaluate ------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Two videos' results (one as an export directory, one as a CSV) and
    their ground truths, with seeded counts."""
    import pandas as pd

    d = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(20261017)
    paths = []
    for v, n in enumerate((40, 25)):
        fns = np.sort(rng.choice(9000, n, replace=False))
        stamps = [export.frame_timestamp(int(f), 30.0).strftime("%H:%M:%S.%f") for f in fns]
        pred = pd.DataFrame({"timestamp": stamps, "framenumber": fns,
                             "predicted": rng.integers(0, 3, n),
                             "rejected": rng.integers(0, 2, n)})
        keep = np.sort(rng.choice(n, n // 2, replace=False))
        gt = pd.DataFrame({"timestamp": [stamps[i] for i in keep], "framenumber": fns[keep],
                           "count": rng.integers(0, 3, len(keep))})
        res_dir = d / f"video{v}"
        res_dir.mkdir()
        res = res_dir / f"video{v}-swifts_full_usec.csv"
        pred.to_csv(res, index=False)
        gt.to_csv(d / f"gt{v}.csv", index=False)
        paths.append((res_dir if v == 0 else res, d / f"gt{v}.csv"))
    return paths


@pytest.mark.parametrize("granularity", ["exact", "second", "minute", "video"])
@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
def test_evaluate_single_video_equals_jax_tool(capsys, results, granularity, json_out):
    (res, gt), _ = results
    argv = ["--results", str(res), "--groundtruth", str(gt), "--granularity", granularity,
            *(["--json"] if json_out else [])]
    ours = _run(capsys, torch_evaluate.main, argv)
    theirs = _run(capsys, evaluate.main, argv)
    assert ours == theirs and ours[0] == 0 and "video0" in ours[1]


@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
def test_evaluate_pairs_with_avg_row_equals_jax_tool(capsys, results, json_out):
    (res0, gt0), (res1, gt1) = results
    argv = ["--pairs", f"{res0}:{gt0}", f"{res1}:{gt1}:June 13", "--granularity", "minute",
            *(["--json"] if json_out else [])]
    ours = _run(capsys, torch_evaluate.main, argv)
    assert ours == _run(capsys, evaluate.main, argv)
    assert "AVG" in ours[1] and "June 13" in ours[1]


def test_evaluate_name_and_errors_equal_jax_tool(capsys, results, tmp_path):
    (res, gt), _ = results
    argv = ["--results", str(res), "--groundtruth", str(gt), "--name", "night 3"]
    assert _run(capsys, torch_evaluate.main, argv) == _run(capsys, evaluate.main, argv)
    for main in (torch_evaluate.main, evaluate.main):
        with pytest.raises(FileNotFoundError, match="no \\*-swifts_full_usec.csv"):
            main(["--results", str(tmp_path), "--groundtruth", str(gt)])
        with pytest.raises(SystemExit):
            main(["--results", str(res)])


# ---- extract_frames --------------------------------------------------------


@pytest.mark.parametrize("kind,extra", [
    ("npy", []), ("npy", ["--start", "5", "--end", "17", "--group-size", "4"]),
    ("avi", ["--group-size", "10"]), ("mp4", ["--end", "12"]),
])
def test_extract_frames_writes_the_jax_tools_pngs(capsys, clips, tmp_path, kind, extra):
    trees, outs = [], []
    for name, main in (("ours", torch_extract_frames.main), ("theirs", extract_frames.main)):
        out = tmp_path / name
        rc, text = _run(capsys, main, [str(clips[kind]), "--out", str(out), *extra], out)
        assert rc == 0
        trees.append(_tree(out))
        outs.append(text)
    assert trees[0] == trees[1] and outs[0] == outs[1]
    assert len(trees[0]) > 0 and all(k.endswith(".png") for k in trees[0])


# ---- export_corners --------------------------------------------------------


def test_export_corners_writes_the_jax_tools_attributes(capsys, tmp_path):
    trees = []
    for name, main in (("ours", torch_export_corners.main), ("theirs", export_corners.main)):
        d = tmp_path / name
        d.mkdir()
        videos = [d / "a.mp4", d / "night 2.avi"]
        rc, text = _run(capsys, main, [*map(str, videos), "--corners", "134,138,192,138"], d)
        assert rc == 0 and text.count("wrote") == 2
        trees.append((_tree(d), text))
    assert trees[0] == trees[1]
    assert set(trees[0][0]) == {"a/attributes.json", "night 2/attributes.json"}


# ---- make_h5_cache ---------------------------------------------------------


@pytest.mark.parametrize("kind,quality", [("npy", 95), ("avi", 80), ("mp4", 95)])
def test_make_h5_cache_writes_the_jax_tools_datasets(clips, tmp_path, kind, quality):
    import h5py

    got = []
    for name, make in (("ours", torch_make_h5_cache.make_cache),
                       ("theirs", make_h5_cache.make_cache)):
        out = tmp_path / f"{name}.h5"
        n = make(clips[kind], out, quality=quality, status=False)
        with h5py.File(out, "r") as fh:
            dset = fh["VideoFrames"]
            got.append((n, dict(fh.attrs), dset.dtype, [bytes(b) for b in dset[:]]))
    assert got[0][0] == got[1][0] == 24
    assert got[0][1] == got[1][1] and got[0][2] == got[1][2]
    assert got[0][3] == got[1][3] and all(got[0][3])


def test_make_h5_cache_main_equals_jax_tool(capsys, clips, tmp_path):
    import h5py

    outs = []
    for name, main in (("ours", torch_make_h5_cache.main), ("theirs", make_h5_cache.main)):
        out = tmp_path / f"{name}.h5"
        rc, text = _run(capsys, main, [str(clips["npy"]), "-o", str(out), "--quality", "90"], out)
        assert rc == 0
        with h5py.File(out, "r") as fh:
            outs.append((text, [bytes(b) for b in fh["VideoFrames"][:]]))
    assert outs[0] == outs[1]
