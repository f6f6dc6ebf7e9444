"""The port's CLI (swiftwatcher_tpu_torch/__main__.py) vs the JAX package's
on a .npy clip, warm and cold start, with the host tracker and with each
CLI's default (the device tracker): the same printed counts and byte-equal
CSVs.  Each CLI gets its own copy of the clip and its attributes.json,
since both write next to the video.  Flags the port has not ported raise,
naming their ROADMAP.md item.  The cv2 container source reads an MJPG AVI
as the JAX package's cv2 backend does."""

import os

import numpy as np
import pytest
import torch

from swiftwatcher_tpu import ui as jax_ui
from swiftwatcher_tpu.__main__ import main as jax_main
from swiftwatcher_tpu.io.readers import VideoFileSource as JaxVideoFileSource
from swiftwatcher_tpu_torch import ui
from swiftwatcher_tpu_torch.__main__ import main
from swiftwatcher_tpu_torch.io.source import VideoFileSource, open_source
from swiftwatcher_tpu_torch.io.synthetic import make_video


@pytest.fixture(autouse=True, scope="module")
def _isolated_compile_cache(tmp_path_factory):
    """The JAX CLI enables the persistent XLA compile cache; send it to a
    throwaway dir and turn it off again afterwards (tests/test_cli.py)."""
    old = os.environ.get("SWTPU_COMPILE_CACHE")
    os.environ["SWTPU_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("xla_cache"))
    yield
    if old is None:
        os.environ.pop("SWTPU_COMPILE_CACHE", None)
    else:
        os.environ["SWTPU_COMPILE_CACHE"] = old
    import jax

    jax.config.update("jax_compilation_cache_dir", None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on one host, and torch's default of a thread
    per core makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def video():
    return make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)


def _clip(root, video, save_corners=ui.save_corners_to_file):
    root.mkdir(parents=True, exist_ok=True)
    p = root / "clip.npy"
    np.save(p, video.frames)
    save_corners(p, video.corners)
    return p


def _count_lines(out):
    return [ln for ln in out.splitlines() if "predicted" in ln or "No events" in ln]


# (rpca_warm_basis, tracker flags): the host tracker, and each CLI's default
# tracker (device in both)
CLI_CASES = [pytest.param("true", ["--tracker", "host"], id="true"),
             pytest.param("false", ["--tracker", "host"], id="false"),
             pytest.param("true", [], id="true-default-tracker"),
             pytest.param("false", [], id="false-default-tracker")]


@pytest.mark.parametrize("warm, tracker", CLI_CASES)
def test_cli_vs_jax_counts_and_csvs(tmp_path, video, capsys, warm, tracker):
    ours = _clip(tmp_path / "torch", video)
    theirs = _clip(tmp_path / "jax", video, jax_ui.save_corners_to_file)
    s = ["--set", f"rpca_warm_basis={warm}", *tracker]
    assert main(["--filepaths", str(ours), "--device", "cpu", *s]) == 0
    out_ours = capsys.readouterr().out
    assert jax_main(["--filepaths", str(theirs), *s]) == 0
    out_theirs = capsys.readouterr().out
    assert _count_lines(out_ours) == _count_lines(out_theirs)
    assert "clip: 2 predicted / 1 rejected swifts." in out_ours
    names = sorted(p.name for p in (theirs.parent / "clip").glob("*.csv"))
    assert len(names) == 6
    assert sorted(p.name for p in (ours.parent / "clip").glob("*.csv")) == names
    for n in names:
        assert (ours.parent / "clip" / n).read_bytes() == (theirs.parent / "clip" / n).read_bytes()


@pytest.mark.parametrize("flags, item", [
    (["--profile"], "item 2"),
    (["--mesh", "2"], "item 6"),
    (["--parallel-videos", "2"], "item 3"),
    (["--accuracy-pack"], "item 5"),
])
def test_unported_flags_raise(tmp_path, video, flags, item):
    clip = _clip(tmp_path, video)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md section 1 {item}"):
        main(["--filepaths", str(clip), "--device", "cpu", *flags])


def test_pickers_and_hdf5_raise(tmp_path, video):
    clip = tmp_path / "clip.npy"
    np.save(clip, video.frames)          # no attributes.json
    with pytest.raises(NotImplementedError, match="item 3, interactive pickers"):
        main(["--filepaths", str(clip), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 3, interactive pickers"):
        main(["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 3, readers"):
        open_source(tmp_path / "clip.h5")


def test_defaults_run_on_the_card_with_the_device_tracker():
    args = ui.parse_args(["--filepaths", "x.npy"])
    assert args.device == "cuda" and args.tracker == "device"
    assert jax_ui.parse_args(["--filepaths", "x.npy"]).tracker == args.tracker


def _read_all(src, n):
    frames, numbers = [], []
    for _ in range(n):
        f, num, _ = src.get_frame()
        frames.append(np.array(f))
        numbers.append(num)
    return frames, numbers


def test_cv2_container_source_vs_jax(tmp_path, video):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "clip.avi"
    H, W = video.frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (W, H))
    for f in video.frames[:12]:
        writer.write(f)
    writer.release()
    ours = open_source(path)
    theirs = JaxVideoFileSource(path, backend="cv2")
    assert isinstance(ours, VideoFileSource)
    assert ours.fps == theirs.fps == 25.0
    assert (ours.start_frame, ours.end_frame, ours.total_frames) == (
        theirs.start_frame, theirs.end_frame, theirs.total_frames)
    # past the end: the inclusive end frame fails to decode, then null frames
    a, na = _read_all(ours, 15)
    b, nb = _read_all(theirs, 15)
    assert na == nb and na[:13] == list(range(13)) and na[13:] == [-1, -1]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert ours.read_errors == theirs.read_errors == 1
    with pytest.raises(NotImplementedError, match="item 3, readers"):
        VideoFileSource(path, backend="native")
    ours.close()
