"""The port's CLI (swiftwatcher_tpu_torch/__main__.py) vs the JAX package's
on a .npy clip, warm and cold start, with the host tracker and with each
CLI's default (the device tracker): the same printed counts and byte-equal
CSVs.  Each CLI gets its own copy of the clip and its attributes.json,
since both write next to the video.  Also against the JAX CLI: an MP4
through each decode backend, --profile (plus its trace and manifest),
--parallel-videos 2, and --accuracy-pack on the jittered accuracy-corpus
scene.  The pickers (cv2 click window, tkinter dialog) are driven through
stand-ins of cv2 and tkinter beside the JAX package's.  --mesh, the last
flag ported (ROADMAP.md section 1 item 6), runs on the CPU's ranks and
refuses more cards than there are as the JAX CLI refuses more devices
(tests/test_torch_mesh_runner.py holds its counts to the JAX package's).
The cv2 container source reads an MJPG AVI as the JAX package's cv2
backend does."""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from swiftwatcher_tpu import ui as jax_ui
from swiftwatcher_tpu.__main__ import main as jax_main
from swiftwatcher_tpu.io.readers import VideoFileSource as JaxVideoFileSource
import swiftwatcher_tpu_torch.__main__ as main_mod
from swiftwatcher_tpu_torch import ui
from swiftwatcher_tpu_torch.__main__ import main
from swiftwatcher_tpu_torch.io.source import VideoFileSource, open_source
from swiftwatcher_tpu_torch.io.synthetic import make_video, write_container

ROOT = Path(__file__).resolve().parent.parent


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
    (["--mesh", "2"], "item 6"),
])
def test_unported_flags_raise(tmp_path, video, capsys, monkeypatch, flags, item):
    """The flag of ROADMAP.md section 1 `item`, which raised
    NotImplementedError before it was ported, now runs: on the CPU its
    CSVs equal the run without it.  On a card it refuses more cards than
    there are, with the JAX CLI's message."""
    plain = _clip(tmp_path / "plain", video)
    assert main(["--filepaths", str(plain), "--device", "cpu"]) == 0
    clip = _clip(tmp_path / "flag", video)
    assert main(["--filepaths", str(clip), "--device", "cpu", *flags]) == 0
    want = _csv_bytes(plain.parent / "clip")
    assert len(want) == 6 and _csv_bytes(clip.parent / "clip") == want
    capsys.readouterr()
    monkeypatch.setattr(main_mod, "require_cuda", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main(["--filepaths", str(clip), *flags]) == 2
    assert "[!] --mesh 2 needs 2 devices; only 1 available." in capsys.readouterr().err


def _csv_bytes(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


def _both_clis(tmp_path, video, flags, name="clip", suffix=".npy"):
    """The clip written for each CLI, both run with `flags`: (port's output
    dir, JAX package's output dir)."""
    dirs = []
    for who, run, save in (("torch", lambda a: main([*a, "--device", "cpu"]),
                            ui.save_corners_to_file),
                           ("jax", jax_main, jax_ui.save_corners_to_file)):
        root = tmp_path / who
        root.mkdir(parents=True, exist_ok=True)
        p = root / f"{name}{suffix}"
        if suffix == ".npy":
            np.save(p, video.frames)
        else:
            assert write_container(p, video.frames, 30.0, "mp4v")
        save(p, video.corners)
        assert run(["--filepaths", str(p), *flags]) == 0
        dirs.append(root / name)
    return dirs


@pytest.mark.parametrize("backend", ["auto", "parallel", "av", "cv2"])
def test_cli_on_an_mp4_vs_jax(tmp_path, video, backend, monkeypatch):
    """The CLI on a real container, through each decode backend (the JAX
    CLI through its auto backend): byte-equal CSVs."""
    from swiftwatcher_tpu_torch.io import native_av

    if backend == "av" and not native_av.is_available():
        pytest.skip("no libav on this host")
    monkeypatch.setenv("SWTPU_DECODE_WORKERS", "2")
    opened = []

    def open_with_backend(path, start=0, end=0):
        # the CLI's open_source with the backend forced (auto: its own)
        src = VideoFileSource(path, end, backend=backend)
        opened.append(src.backend)
        return src

    monkeypatch.setattr(main_mod, "open_source", open_with_backend)
    ours, theirs = _both_clis(tmp_path, video, [], suffix=".mp4")
    want = _csv_bytes(theirs)
    assert len(want) == 6 and _csv_bytes(ours) == want
    assert len(opened) == 1 and opened[0] in ("parallel", "av", "cv2")
    assert backend == "auto" or opened[0] == backend


def test_cli_profile_vs_jax(tmp_path, video):
    ours, theirs = _both_clis(tmp_path, video, ["--profile"])
    want = _csv_bytes(theirs)
    assert len(want) == 6 and _csv_bytes(ours) == want
    trace = json.loads((ours / "profile" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"localize_dispatch", "track_dispatch", "consume"} <= names
    # the manifest goes next to the CSVs when they are written
    manifest = json.loads((ours / "run_manifest.json").read_text())
    assert set(manifest["device_stage_seconds"]) == {"localize", "track_scan"}


@pytest.mark.parametrize("tracker, flags", [
    pytest.param("host", [], id="host"),
    pytest.param("device", [], id="device"),
    pytest.param("device", ["--profile"], id="device-profile"),
])
def test_cli_parallel_videos_vs_jax(tmp_path, capsys, tracker, flags):
    """--parallel-videos 2, also with --profile: one video's run at a time
    holds the profiler (its session is process-wide), a run that starts
    beside it warns and writes no trace, and every run writes its device
    stage times."""
    videos = [make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1),
              make_video(seed=1, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1)]
    outs = {}
    for who, run, save, extra in (("torch", main, ui.save_corners_to_file, ["--device", "cpu"]),
                                  ("jax", jax_main, jax_ui.save_corners_to_file, [])):
        clips = []
        for i, v in enumerate(videos):
            p = tmp_path / who / f"clip{i}.npy"
            p.parent.mkdir(parents=True, exist_ok=True)
            np.save(p, v.frames)
            save(p, v.corners)
            clips.append(str(p))
        assert run(["--filepaths", *clips, "--parallel-videos", "2", "--tracker", tracker,
                    *flags, *extra]) == 0
        outs[who] = capsys.readouterr().out
    assert "frames processed" not in outs["torch"]      # no progress line above 1
    assert _count_lines(outs["torch"]) == _count_lines(outs["jax"])
    for i in range(2):
        want = _csv_bytes(tmp_path / "jax" / f"clip{i}")
        assert len(want) == 6 and _csv_bytes(tmp_path / "torch" / f"clip{i}") == want
    if flags:
        traces = [tmp_path / "torch" / f"clip{i}" / "profile" / "trace.json" for i in range(2)]
        assert any(t.exists() for t in traces)
        for t in filter(Path.exists, traces):
            names = {e.get("name") for e in json.loads(t.read_text())["traceEvents"]}
            assert {"localize_dispatch", "track_dispatch", "consume"} <= names
        for i in range(2):
            manifest = json.loads((tmp_path / "torch" / f"clip{i}" / "run_manifest.json")
                                  .read_text())
            assert set(manifest["device_stage_seconds"]) == {"localize", "track_scan"}


def test_cli_accuracy_pack_vs_jax_on_jitter2(tmp_path):
    """--accuracy-pack (stabilisation, the wide angle band and the
    displacement gate) on the accuracy corpus's jitter2 scene."""
    sys.path.insert(0, str(ROOT / "tools"))
    from torch_accuracy_corpus import BASE, SCENES
    from swiftwatcher_tpu_torch.io.synthetic import make_hard_video

    hard = make_hard_video(**BASE, **SCENES["jitter2"])
    ours, theirs = _both_clis(tmp_path, hard, ["--accuracy-pack"])
    want = _csv_bytes(theirs)
    assert len(want) == 6 and _csv_bytes(ours) == want


class _FakeCv2(types.SimpleNamespace):
    """cv2's window calls, scripted: `keys` are waitKey's answers once
    both corners are in, `clicks` the clicks of each round."""

    EVENT_LBUTTONDOWN, WINDOW_NORMAL, WND_PROP_VISIBLE = 1, 0, 4

    class error(Exception):
        pass

    def __init__(self, frame, clicks, keys, headless=False):
        super().__init__(frame=frame, clicks=list(clicks), keys=list(keys),
                         headless=headless, callback=None)

    def VideoCapture(self, path):
        fake = self

        class Cap:
            def read(self):
                return True, fake.frame.copy()

            def release(self):
                pass

        return Cap()

    def namedWindow(self, *a):
        if self.headless:
            raise self.error("no display")

    def setMouseCallback(self, name, cb):
        self.callback = cb

    def setWindowTitle(self, *a):
        pass

    def imshow(self, *a):
        pass

    def circle(self, *a):
        pass

    def waitKey(self, ms):
        if ms == 1 and self.clicks:
            for x, y in self.clicks.pop(0):
                self.callback(self.EVENT_LBUTTONDOWN, x, y, 0, None)
            return -1
        return ord(self.keys.pop(0)) if ms != 1 else -1

    def getWindowProperty(self, *a):
        return 1

    def destroyAllWindows(self):
        pass


@pytest.mark.parametrize("clicks, keys, want", [
    ([[(10, 20), (30, 40)]], ["y"], [(10, 20), (30, 40)]),
    ([[(1, 2), (3, 4)], [(50, 60), (70, 80)]], ["n", "y"], [(50, 60), (70, 80)]),
    ([[(5, 6), (7, 8), (9, 9)]], ["x", "Y"], [(5, 6), (7, 8)]),
])
def test_corner_picker_vs_jax(monkeypatch, video, clicks, keys, want):
    got = []
    for pick in (ui.select_chimney_corners, jax_ui.select_chimney_corners):
        monkeypatch.setitem(sys.modules, "cv2", _FakeCv2(video.frames[0], clicks, keys))
        got.append(pick(Path("clip.mp4")))
    assert got[0] == got[1] == want


def test_corner_picker_without_a_display_exits_as_jax(monkeypatch, capsys, video):
    errs = []
    for pick in (ui.select_chimney_corners, jax_ui.select_chimney_corners):
        monkeypatch.setitem(sys.modules, "cv2", _FakeCv2(video.frames[0], [], [], headless=True))
        with pytest.raises(SystemExit) as e:
            pick(Path("clip.mp4"))
        assert e.value.code == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "attributes.json" in errs[0]


def _fake_tkinter(chosen):
    filedialog = types.SimpleNamespace(askopenfilenames=lambda **kw: tuple(chosen))

    class Root:
        tk = types.SimpleNamespace(splitlist=lambda files: list(files))

        def withdraw(self):
            pass

    return types.SimpleNamespace(Tk=Root, filedialog=filedialog)


@pytest.mark.parametrize("chosen", [["/v/a.mp4", "/v/b.avi"], []])
def test_file_dialog_vs_jax(monkeypatch, capsys, chosen):
    monkeypatch.setattr("builtins.input", lambda prompt="": "y")
    results = []
    for select in (ui.select_filepaths, jax_ui.select_filepaths):
        monkeypatch.setitem(sys.modules, "tkinter", _fake_tkinter(chosen))
        try:
            results.append(select())
        except SystemExit as e:
            results.append(("exit", e.code))
        results.append(capsys.readouterr())
    assert results[0] == results[2] and results[1] == results[3]
    if chosen:
        assert results[0] == [Path(c) for c in chosen]
        assert "a.mp4" in results[1].out
    else:
        assert results[0] == ("exit", 1) and "No file selected" in results[1].err


def test_cli_without_filepaths_or_tkinter_exits_as_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tkinter", None)
    for run in (lambda: main(["--device", "cpu"]), lambda: jax_ui.select_filepaths()):
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 1
        assert "tkinter unavailable" in capsys.readouterr().err


def test_cli_picks_corners_without_attributes_json(tmp_path, video, monkeypatch):
    """No attributes.json: the CLI asks the picker for the corners."""
    clip = tmp_path / "clip.npy"
    np.save(clip, video.frames)
    asked = []

    def pick(path):
        asked.append(path)
        return video.corners

    monkeypatch.setattr(ui, "select_chimney_corners", pick)
    assert main(["--filepaths", str(clip), "--device", "cpu", "--tracker", "host"]) == 0
    assert asked == [clip.resolve()]
    assert len(list((tmp_path / "clip").glob("*.csv"))) == 6


def test_hdf5_without_h5py_raises_a_named_error(tmp_path, monkeypatch):
    """The card's machine has no h5py: the CLI's open_source says so."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
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
    path = tmp_path / "clip.avi"
    assert write_container(path, video.frames[:12], 25.0, "MJPG")
    ours = VideoFileSource(path, backend="cv2")
    theirs = JaxVideoFileSource(path, backend="cv2")
    assert ours.backend == theirs.backend == "cv2"
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
    ours.close()
