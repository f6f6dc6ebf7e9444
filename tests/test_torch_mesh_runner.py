"""run_video(mesh=...) and the CLI's --mesh of the port, on gloo ranks on the
CPU, against the JAX package's mesh mode (tests/test_multichip.py's scene
and settings: batch_windows 4, track_enum_lap 4) and against the port's
unsharded runs: with the host and the device tracker, with --classify
(a weight set that rejects part of the segments, so that the keep-mask
shows in the events), with --parallel-videos 2 (the videos share the mesh),
with stabilisation (--accuracy-pack), and cut and resumed from a
checkpoint.  Events and totals are equal throughout."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import swiftwatcher_tpu_torch.__main__ as main_mod
from swiftwatcher_tpu import ui as jax_ui
from swiftwatcher_tpu.__main__ import main as jax_main
from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.models.classifier import SqueezeNetSegmentFilter as JaxFilter
from swiftwatcher_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch import ui
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.source import ArraySource
from swiftwatcher_tpu_torch.io.synthetic import make_video
from swiftwatcher_tpu_torch.models.classifier import DEFAULT_WEIGHTS, SqueezeNetSegmentFilter
from swiftwatcher_tpu_torch.models.squeezenet import params_from_jax
from swiftwatcher_tpu_torch.parallel.mesh import make_mesh, ping
from swiftwatcher_tpu_torch.pipeline.runner import run_video

CPU = torch.device("cpu")
CFG = dataclasses.replace(DEFAULT_CONFIG, batch_windows=4, track_enum_lap=4)
JAX_CFG = dataclasses.replace(JAX_CONFIG, batch_windows=4, track_enum_lap=4)


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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((4, 2), device="cpu", timeout=120) as m:
        yield m


@pytest.fixture(scope="module")
def video():
    return make_video(seed=2, n_frames=63, n_entering=2, n_crossing=1)


def _events(r):
    return [(e.frame_number, e.first_centroid, e.last_centroid) for e in r.events]


def _run(video, cfg=CFG, **kw):
    return run_video(ArraySource(video.frames, fps=video.fps), video.corners, cfg, CPU, **kw)


@pytest.fixture(scope="module")
def jax_mesh_run(video, cpu_devices):
    return jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners, JAX_CFG,
                         mesh=jax_make_mesh(8, shape=(4, 2)), tracker_impl="device")


@pytest.mark.parametrize("impl", ["host", "device"])
def test_run_video_mesh_matches_jax_mesh_and_unsharded(mesh, video, jax_mesh_run, impl):
    sharded = _run(video, mesh=mesh, tracker_impl=impl)
    base = _run(video, tracker_impl=impl)
    assert _events(sharded) == _events(base)
    assert sharded.ialm_iters == pytest.approx(base.ialm_iters, abs=1)
    assert sharded.frames_processed == base.frames_processed == len(video.frames)
    want = jax_mesh_run
    assert (sharded.total_predicted, sharded.total_rejected) == (
        want.total_predicted, want.total_rejected) == (2, 0)
    assert [e[0] for e in _events(sharded)] == [e.frame_number for e in want.events]
    for ours, theirs in zip(sharded.events, want.events):
        np.testing.assert_allclose(ours.first_centroid + ours.last_centroid,
                                   theirs.first_centroid + theirs.last_centroid, atol=1e-3)


def test_run_video_mesh_with_stabilisation(mesh, video):
    cfg = dataclasses.replace(CFG, stabilize_max_shift=3)
    assert _events(_run(video, cfg, mesh=mesh)) == _events(_run(video, cfg))


def test_batch_windows_must_divide_the_data_axis(mesh, video):
    with pytest.raises(ValueError, match="must divide over the mesh 'data' axis"):
        _run(video, dataclasses.replace(CFG, batch_windows=3), mesh=mesh)


@pytest.mark.parametrize("impl", ["host", "device"])
def test_checkpointed_mesh_run_resumes_to_the_uncut_run(tmp_path, mesh, impl):
    video = make_video(seed=0, n_frames=105, n_entering=4, n_crossing=1, n_vanishing=2)
    cfg = CFG                                   # 105 frames: 5 windows, 2 batches
    uncut = _run(video, cfg, mesh=mesh, tracker_impl=impl)
    ck = tmp_path / "ck.json"

    class Cut(Exception):
        pass

    def cut(done, total):
        raise Cut

    with pytest.raises(Cut):
        _run(video, cfg, mesh=mesh, tracker_impl=impl, checkpoint_path=ck,
             checkpoint_interval_batches=1, status_cb=cut)
    assert ck.is_file()
    resumed = _run(video, cfg, mesh=mesh, tracker_impl=impl, checkpoint_path=ck,
                   checkpoint_interval_batches=1)
    assert _events(resumed) == _events(uncut)
    assert (resumed.total_predicted, resumed.total_rejected) == (
        uncut.total_predicted, uncut.total_rejected)


def _clip(root, video, save):
    root.mkdir(parents=True, exist_ok=True)
    p = root / "clip.npy"
    np.save(p, video.frames)
    save(p, video.corners)
    return p


def _csvs(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


def _partial_weights():
    """The shipped weights with classifier.1.bias[1] at -150: they reject
    part of the segments and move the events (on this scene 2 predicted /
    1 rejected becomes 2 / 0; tests/test_torch_classify_runner.py)."""
    with np.load(DEFAULT_WEIGHTS) as data:
        params = {k: data[k].copy() for k in data.files}
    params["classifier.1.bias"][1] = -150.0
    return params


def test_cli_mesh_classify_matches_jax_mesh_and_unsharded(tmp_path, mesh, cpu_devices,
                                                          monkeypatch, capsys):
    """--mesh 2x2 --classify --export through the port's CLI (its own mesh:
    the module's is closed first) against the JAX CLI's --mesh 2x2
    --classify and the port's CLI without --mesh: the same six CSVs, and
    the same segment PNGs as without --mesh (the tables come back to rank
    0 with their bboxes)."""
    mesh.close()
    video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
    weights = _partial_weights()
    monkeypatch.setattr(SqueezeNetSegmentFilter, "from_default_weights", classmethod(
        lambda cls, cfg, device: cls(params_from_jax(weights, device), cfg, device)))
    monkeypatch.setattr(JaxFilter, "from_default_weights", classmethod(
        lambda cls, cfg=JAX_CONFIG: cls(weights, cfg)))
    flags = ["--classify", "--set", "batch_windows=4"]
    made = []
    real_make_mesh = main_mod.make_mesh
    monkeypatch.setattr(main_mod, "make_mesh",
                        lambda *a, **k: made.append(real_make_mesh(*a, **k)) or made[-1])
    ours = _clip(tmp_path / "mesh", video, ui.save_corners_to_file)
    assert main_mod.main(["--filepaths", str(ours), "--device", "cpu", "--mesh", "2x2",
                          "--export", *flags]) == 0
    assert len(made) == 1 and made[0].shape == {"data": 2, "model": 2}
    assert "clip: 2 predicted / 0 rejected swifts." in capsys.readouterr().out
    with pytest.raises(Exception, match="closed"):
        made[0].run(ping)                         # the CLI closed its mesh
    plain = _clip(tmp_path / "plain", video, ui.save_corners_to_file)
    assert main_mod.main(["--filepaths", str(plain), "--device", "cpu", "--export",
                          *flags]) == 0
    theirs = _clip(tmp_path / "jax", video, jax_ui.save_corners_to_file)
    assert jax_main(["--filepaths", str(theirs), "--mesh", "2x2", *flags]) == 0
    want = _csvs(theirs.parent / "clip")
    assert len(want) == 6
    assert _csvs(ours.parent / "clip") == want
    assert _csvs(plain.parent / "clip") == want
    pngs = [{p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*.png"))}
            for d in (ours.parent / "clip" / "segments", plain.parent / "clip" / "segments")]
    assert pngs[0] and pngs[0] == pngs[1]


@pytest.mark.parametrize("args, message", [
    (["--mesh", "2y"], "--mesh must look like DATAxMODEL (e.g. 4x2), got '2y'."),
], ids=["malformed"])
def test_cli_refuses_a_malformed_mesh_as_jax_does(tmp_path, capsys, args, message):
    video = make_video(seed=0, n_frames=21, n_entering=0, n_crossing=0)
    clip = _clip(tmp_path / "torch", video, ui.save_corners_to_file)
    assert main_mod.main(["--filepaths", str(clip), "--device", "cpu", *args]) == 2
    assert message in capsys.readouterr().err
    assert jax_main(["--filepaths", str(clip), *args]) == 2
    assert message in capsys.readouterr().err


def test_cli_parallel_videos_share_the_mesh(tmp_path, capsys):
    """--parallel-videos 2 --mesh 2x1: the two videos' runs share one mesh
    (its runs serialised under its lock) and write the CSVs of two
    sequential runs without --mesh."""
    videos = [make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1),
              make_video(seed=1, n_frames=50, n_entering=2, n_crossing=1, n_vanishing=1)]
    outs = {}
    for name, flags in (("mesh", ["--parallel-videos", "2", "--mesh", "2x1"]),
                        ("seq", [])):
        clips = [str(_clip(tmp_path / name / f"v{i}", v, ui.save_corners_to_file))
                 for i, v in enumerate(videos)]
        assert main_mod.main(["--filepaths", *clips, "--device", "cpu", *flags]) == 0
        outs[name] = [_csvs(tmp_path / name / f"v{i}" / "clip") for i in range(2)]
    capsys.readouterr()
    assert all(len(c) == 6 for c in outs["seq"])
    assert outs["mesh"] == outs["seq"]
