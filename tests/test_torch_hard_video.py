"""The port's hard-scene corpus and its CSV scoring against the JAX
package's, on the CPU: make_hard_video gives the JAX generator's frames,
corners, entry frames and distractor count on every scene of
tools/accuracy_corpus.py:SCENES; dataframe_from_csv reads the port's CSVs
as the JAX function does; and tools/torch_accuracy_corpus.py scores two
scenes as tools/accuracy_corpus.py does, with the container scenes listed
as not run where no H.264 writer is built."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from swiftwatcher_tpu.io import export as jax_export
from swiftwatcher_tpu.io.synthetic import make_hard_video as jax_make_hard_video
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io import export
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import HardVideo, make_hard_video
from swiftwatcher_tpu_torch.pipeline.runner import run_video

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import accuracy_corpus  # noqa: E402
import torch_accuracy_corpus  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(name):
    spec = dict(accuracy_corpus.SCENES[name])
    spec.pop("recompress", None)
    spec.pop("vfr", None)
    return spec


@pytest.mark.parametrize("name", list(accuracy_corpus.SCENES))
def test_make_hard_video_equals_jax_on_every_scene(name):
    ours = make_hard_video(**accuracy_corpus.BASE, **_spec(name))
    theirs = jax_make_hard_video(**accuracy_corpus.BASE, **_spec(name))
    assert isinstance(ours, HardVideo)
    assert ours.frames.dtype == theirs.frames.dtype == np.uint8
    np.testing.assert_array_equal(ours.frames, theirs.frames)
    assert ours.corners == theirs.corners and ours.fps == theirs.fps
    assert ours.entry_frames == theirs.entry_frames and ours.entry_frames
    assert ours.n_distractors == theirs.n_distractors


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_frames=30, H=180, W=260, n_entering=2, n_flyby=1, jitter=1, occluder=True),
    dict(seed=5, n_frames=40, n_entering=4, simultaneous=True, motion_blur=0.3, flicker=0.1,
         brightness_drift=0.2),
])
def test_make_hard_video_equals_jax_off_corpus(kw):
    ours, theirs = make_hard_video(**kw), jax_make_hard_video(**kw)
    np.testing.assert_array_equal(ours.frames, theirs.frames)
    assert (ours.corners, ours.entry_frames, ours.n_distractors) == (
        theirs.corners, theirs.entry_frames, theirs.n_distractors)


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """The port's six CSVs of the crowded scene."""
    video = make_hard_video(**accuracy_corpus.BASE, **_spec("crowded"))
    out = tmp_path_factory.mktemp("crowded")
    run_video(ArraySource(video.frames, fps=video.fps), video.corners, DEFAULT_CONFIG, CPU,
              export_dir=out)
    return out


def test_dataframe_from_csv_equals_jax(results_dir):
    csvs = sorted(results_dir.glob("*.csv"))
    assert len(csvs) == 6
    for p in csvs:
        if "_usec" not in p.name:
            continue        # the per-second and per-minute files have no framenumber
        ours, theirs = export.dataframe_from_csv(p), jax_export.dataframe_from_csv(p)
        pd.testing.assert_frame_equal(ours, theirs)
        assert list(ours.index.names) == ["timestamp", "framenumber"]


def test_dataframe_round_trip_and_centroid_lists(tmp_path):
    df = pd.DataFrame({
        "timestamp": ["00:00:00.033333", "00:00:01.500000"],
        "framenumber": [1, 45],
        "centroid": ["[(1.0, 2.5), (3.25, 4.0)]", "[(7.0, 8.0)]"],
        "predicted": [1, 0],
    })
    ours_path, theirs_path = tmp_path / "a" / "ours.csv", tmp_path / "b" / "theirs.csv"
    export.dataframe_to_csv(df, ours_path)
    jax_export.dataframe_to_csv(df, theirs_path)
    assert ours_path.read_bytes() == theirs_path.read_bytes()
    ours, theirs = export.dataframe_from_csv(ours_path), jax_export.dataframe_from_csv(ours_path)
    pd.testing.assert_frame_equal(ours, theirs)
    assert ours["centroid"].tolist() == [[[1.0, 2.5], [3.25, 4.0]], [[7.0, 8.0]]]
    plain = df.copy()
    assert export.list_to_float(plain, "centroid")["centroid"].tolist() == \
        jax_export.list_to_float(df.copy(), "centroid")["centroid"].tolist()


def test_corpus_scores_two_scenes_as_the_jax_tool(tmp_path):
    """tools/torch_accuracy_corpus.py on clean and flyby_trap (the host
    tracker, the CPU): the JAX tool's scores, events and totals."""
    names = ["clean", "flyby_trap"]
    ours, _ = torch_accuracy_corpus.score_corpus(names, CPU, variants=False)
    for name in names:
        r = accuracy_corpus.run_scene(name, accuracy_corpus.SCENES[name], tmp_path / name,
                                      "second")
        got = ours["scenes"][name]
        assert (got["events_detected"], got["predicted"], got["rejected"]) == (
            r["events"], r["predicted"], r["rejected"])
        for kind, s in r["scores"].items():
            assert (got[kind]["tp"], got[kind]["fp"], got[kind]["missed"]) == (
                s.tp, s.fp, s.missed), (name, kind)
    assert ours["scenes"]["clean"]["detection"]["f1"] == 1.0
    assert ours["not_run"] == {}


def test_corpus_cli_lists_container_scenes_it_cannot_write(tmp_path, monkeypatch):
    """Without an H.264 writer (as on a host whose libav is missing) the
    container scenes are listed as not run, by name, and no other scene
    takes their place."""
    from swiftwatcher_tpu_torch.io import native_av

    monkeypatch.setattr(native_av, "write_test_video", lambda *a, **k: False)
    monkeypatch.setattr(native_av, "write_test_video_vfr", lambda *a, **k: False)
    out = tmp_path / "corpus.json"
    assert torch_accuracy_corpus.main(["--scenes", "h264_blur", "vfr_capture", "--device",
                                       "cpu", "--no-variants", "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["not_run"] == {"h264_blur": "no H.264 writer", "vfr_capture": "no H.264 writer"}
    assert got["scenes"] == {}


def test_corpus_tool_runs_as_a_script(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_accuracy_corpus.py"), "--scenes", "jitter1",
         "--device", "cpu", "--no-variants", "--json", "-"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert list(got["scenes"]) == ["jitter1"] and got["device"] == "cpu"
    assert got["scenes"]["jitter1"]["gt_entries"] == 3
