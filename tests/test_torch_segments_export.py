"""--export (swiftwatcher_tpu_torch/io/segments_export.py) vs the JAX
package's: the same PNG names and pixels for the same frames and tables,
with and without a keep-mask; and the CLI with --classify --export on a
.npy clip: the printed counts, six CSVs byte-equal to the JAX CLI's and
the same PNG set, pixel for pixel."""

import os
import warnings

import cv2
import numpy as np
import pytest
import torch

from swiftwatcher_tpu import ui as jax_ui
from swiftwatcher_tpu.__main__ import main as jax_main
from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.segments_export import export_frame_segments as jax_export
from swiftwatcher_tpu_torch import ui
from swiftwatcher_tpu_torch.__main__ import main
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.io.segments_export import export_frame_segments
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
    """One intra-op thread while this module runs (several test workers
    share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pngs(root):
    """{relative path: pixels} of every PNG under root."""
    return {str(p.relative_to(root)): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*.png"))}


def _assert_same_pngs(ours, theirs):
    a, b = _pngs(ours), _pngs(theirs)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


class Table:
    """A host RegionTable stand-in: (B, T, 256) planes, bboxes inside the
    crop and some past its edges."""

    def __init__(self, rng, B, T, H, W):
        shape = (B, T, 256)
        self.valid = np.zeros(shape, bool)
        self.min_y, self.min_x, self.max_y, self.max_x = (np.zeros(shape, np.int32)
                                                          for _ in range(4))
        for b in range(B):
            for t in range(T):
                for k in sorted(rng.choice(np.arange(1, 40), rng.integers(1, 6), replace=False)):
                    y, x = rng.integers(0, H - 1), rng.integers(0, W - 1)
                    self.valid[b, t, k] = True
                    self.min_y[b, t, k], self.min_x[b, t, k] = y, x
                    self.max_y[b, t, k] = min(H, y + rng.integers(1, 30))
                    self.max_x[b, t, k] = min(W, x + rng.integers(1, 30))


@pytest.mark.parametrize("with_keep", [False, True])
def test_export_frame_segments_vs_jax(tmp_path, with_keep):
    rng = np.random.default_rng(3 + with_keep)
    crop_region = ((30, 20), (30 + 150, 20 + 100))
    table = Table(rng, 2, 3, 100, 150)
    frames = rng.integers(0, 256, (2, 3, 160, 220, 3), np.uint8)
    written = 0
    for b in range(2):
        for t in range(3):
            n = int(table.valid[b, t].sum())
            keep = [bool(v) for v in rng.integers(0, 2, n)] if with_keep else None
            args = (table, (b, t), 100 + 3 * b + t, crop_region)
            got = export_frame_segments(frames[b, t], *args, tmp_path / "torch", "clip",
                                        DEFAULT_CONFIG, keep=keep)
            want = jax_export(frames[b, t], *args, tmp_path / "jax", "clip", JAX_CONFIG,
                              keep=keep)
            assert got == want
            written += got
    assert written > 0
    _assert_same_pngs(tmp_path / "torch", tmp_path / "jax")
    assert len(list((tmp_path / "torch" / "overlay").glob("*.png"))) == written


def test_export_with_nothing_kept_writes_only_the_directories(tmp_path):
    table = Table(np.random.default_rng(0), 1, 1, 100, 150)
    n = int(table.valid[0, 0].sum())
    frame = np.zeros((160, 220, 3), np.uint8)
    assert export_frame_segments(frame, table, (0, 0), 5, ((30, 20), (180, 120)),
                                 tmp_path, "clip", DEFAULT_CONFIG, keep=[False] * n) == 0
    assert (tmp_path / "overlay").is_dir() and not list(tmp_path.rglob("*.png"))


def _clip(root, video, save_corners):
    root.mkdir(parents=True, exist_ok=True)
    p = root / "clip.npy"
    np.save(p, video.frames)
    save_corners(p, video.corners)
    return p


@pytest.mark.parametrize("tracker", [[], ["--tracker", "host"]], ids=["default", "host"])
def test_cli_classify_export_vs_jax(tmp_path, capsys, tracker):
    """The port's default (device) tracker exports from its own read-back
    planes, with no warning; the JAX CLI falls back to its host tracker
    for --export.  Both give the same CSVs and PNGs."""
    video = make_video(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1)
    ours = _clip(tmp_path / "torch", video, ui.save_corners_to_file)
    theirs = _clip(tmp_path / "jax", video, jax_ui.save_corners_to_file)
    flags = ["--classify", "--export", *tracker]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert main(["--filepaths", str(ours), "--device", "cpu", *flags]) == 0
    out_ours = capsys.readouterr().out
    assert jax_main(["--filepaths", str(theirs), *flags]) == 0
    out_theirs = capsys.readouterr().out
    lines = [[ln for ln in out.splitlines() if "predicted" in ln or "No events" in ln]
             for out in (out_ours, out_theirs)]
    assert lines[0] == lines[1] and lines[0]
    ours_dir, theirs_dir = ours.parent / "clip", theirs.parent / "clip"
    names = sorted(p.name for p in theirs_dir.glob("*.csv"))
    assert len(names) == 6
    assert sorted(p.name for p in ours_dir.glob("*.csv")) == names
    for n in names:
        assert (ours_dir / n).read_bytes() == (theirs_dir / n).read_bytes()
    assert len(_pngs(ours_dir / "segments")) > 0
    _assert_same_pngs(ours_dir / "segments", theirs_dir / "segments")

