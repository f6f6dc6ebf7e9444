"""The port's campaign and measurement tools against their JAX-side
originals on the same seeds: tools/torch_rpca_fixed_counts.py vs
tools/rpca_fixed_counts.py (the scene stream and the dynamic counts),
tools/torch_bench_rpca.py vs tools/bench_rpca.py (the batch, bit for bit,
and the shipped solver's iterations within 1: PARITY deviations 3 and 8),
tools/torch_mesh_scaling.py vs tools/mesh_scaling.py (the points' keys,
gloo ranks on the CPU, and the committed MESH_SCALING.json untouched),
tools/torch_decode_floor.py vs tools/decode_floor.py (the frames decoded,
every mode's rate, and the exit 2 without libav) and
tools/torch_accuracy_seed_sweep.py vs tools/accuracy_seed_sweep.py (the
F1 rows).  Every tool raises for --device cuda without a card."""

import json
import os
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.io.readers import ArraySource as JaxArraySource
from swiftwatcher_tpu.io.synthetic import make_video as jax_make_video
from swiftwatcher_tpu.ops.rpca import ialm_gates_and_kwargs as jax_gates
from swiftwatcher_tpu.ops.rpca import ialm_rpca_batched as jax_ialm_rpca_batched
from swiftwatcher_tpu.pipeline.runner import run_video as jax_run_video
from swiftwatcher_tpu_torch.io import native_av

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import accuracy_seed_sweep  # noqa: E402
import decode_floor  # noqa: E402
import parity_fuzz  # noqa: E402
import torch_accuracy_seed_sweep  # noqa: E402
import torch_bench_rpca  # noqa: E402
import torch_decode_floor  # noqa: E402
import torch_mesh_scaling  # noqa: E402
import torch_parity_fuzz  # noqa: E402
import torch_rpca_fixed_counts  # noqa: E402

CPU = torch.device("cpu")
SEED = 20260820
# the mesh's deadline for a start, a run and a collective: a hung gloo
# collective fails the test within it instead of stalling an xdist worker
MESH_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_bench_rpca(tmp_path_factory):
    """tools/bench_rpca.py, imported with its compile cache pointed into a
    temporary directory and the process's setting restored after: its
    import sets JAX's persistent cache directory."""
    before = jax.config.jax_compilation_cache_dir
    env = os.environ.get("SWTPU_COMPILE_CACHE")
    os.environ["SWTPU_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("xla_cache"))
    try:
        import bench_rpca
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        if env is None:
            del os.environ["SWTPU_COMPILE_CACHE"]
        else:
            os.environ["SWTPU_COMPILE_CACHE"] = env
    return bench_rpca


def test_scene_params_stream_equals_jax():
    ours, theirs = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for i in range(40):
        assert torch_parity_fuzz.scene_params(ours, i) == parity_fuzz.scene_params(theirs, i)


def test_fixed_counts_dynamic_equals_jax_run_video(tmp_path):
    """Two scenes, one per tracker: no mismatch, and each scene's dynamic
    counts equal the JAX package's run_video on the same scene."""
    summary = torch_rpca_fixed_counts.run_campaign(2, 15, SEED, str(tmp_path / "r.json"),
                                                   device=CPU)
    assert summary["mismatches"] == 0
    assert [r["tracker"] for r in summary["results"]] == ["device", "host"]
    for row in summary["results"]:
        video = jax_make_video(**row["params"])
        res = jax_run_video(JaxArraySource(video.frames, fps=video.fps), video.corners,
                            JAX_CONFIG, tracker_impl=row["tracker"])
        assert row["dynamic"] == parity_fuzz._counts(res), row["scene"]
    assert json.loads((tmp_path / "r.json").read_text())["results"] == summary["results"]


def test_bench_rpca_batch_and_production_iterations_equal_jax(jax_bench_rpca):
    X = torch_bench_rpca.make_batch(2, CPU)
    X_jax = np.asarray(jax_bench_rpca.make_batch(2))
    assert X.dtype == torch.float32 and tuple(X.shape) == (2, 21, 216 * 432)
    np.testing.assert_array_equal(X.numpy(), X_jax)

    (row,) = torch_bench_rpca.run_variants(X, ["production"], reps=1)
    _, kw = jax_gates(JAX_CONFIG, jnp.dtype(JAX_CONFIG.rpca_dtype))
    kw = {k: v for k, v in kw.items() if k in torch_bench_rpca.STORAGE_KEYS}
    _, _, iters = jax_ialm_rpca_batched(
        jnp.asarray(X_jax), lmbda=JAX_CONFIG.rpca_lambda, tol=JAX_CONFIG.rpca_tol,
        max_iter=JAX_CONFIG.rpca_max_iter, **kw)
    assert np.abs(row["iters"].astype(int) - np.asarray(iters).astype(int)).max() <= 1
    assert 0 < row["trips"] <= JAX_CONFIG.rpca_max_iter
    assert row["ms"] > 0 and row["event_ms"] is None and row["drift"] == 0


def test_bench_rpca_variants_match_the_jax_tool():
    """The same variant names, and production the shipped keywords that the
    JAX package's gate helper gives (K6 off on the CPU, as the JAX front is
    off away from the TPU)."""
    src = (ROOT / "tools" / "bench_rpca.py").read_text()
    table = torch_bench_rpca.variants(CPU)
    assert all(f'"{name}"' in src for name in table)
    _, kw = jax_gates(JAX_CONFIG, jnp.dtype(JAX_CONFIG.rpca_dtype))
    want = {k: v for k, v in kw.items() if k in torch_bench_rpca.STORAGE_KEYS}
    assert table["production"] == want


def test_mesh_scaling_points_and_committed_file(capsys, tmp_path):
    committed = ROOT / "MESH_SCALING.json"
    before = committed.read_bytes()
    want = json.loads(before)
    out = tmp_path / "scaling.json"
    rc = torch_mesh_scaling.main(["--sizes", "1", "2", "--iters", "1", "--repeats", "1",
                                  "--device", "cpu", "--timeout", str(MESH_TIMEOUT),
                                  "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert committed.read_bytes() == before
    assert [r["data_devices"] for r in got["results"]] == [1, 2]
    assert [r["model_devices"] for r in got["model_axis_results"]] == [1, 2]
    for key in ("results", "model_axis_results"):
        for r in got[key]:
            assert set(r) == set(want[key][0]), key
            assert r["elapsed_s"] > 0 and r["unsharded_same_batch_s"] > 0
    assert set(want) - {"r4_2dev_anomaly"} <= set(got)
    assert got["mesh_backends"] == {"data=1": "gloo", "data=2": "gloo", "model=1": "gloo",
                                    "model=2": "gloo"}
    assert got["substrate"] == "1 rank on the CPU, gloo; 2 ranks on the CPU, gloo"
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):printed.rindex("}") + 1]) == got


def test_decode_floor_equals_jax_tool(capsys):
    if not native_av.is_available():
        pytest.skip("libav native decoder unavailable")
    args = ["--frames", "63", "--passes", "1"]
    rc = torch_decode_floor.main(args + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if rc == 2 and ours == {"error": "no H.264 encoder"}:
        pytest.skip("no libx264 encoder on this host")
    assert rc == 0, ours
    assert decode_floor.main(args) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["frames"] == theirs["frames"] == 63
    assert set(ours["fps"]) == set(theirs["fps"]) == {"null", "gray_crop", "full_bgr", "cv2"}
    assert all(v > 0 for v in ours["fps"].values())
    assert set(theirs) <= set(ours)


def test_decode_floor_without_libav_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(native_av, "is_available", lambda: False)
    assert torch_decode_floor.main(["--frames", "63", "--passes", "1", "--device", "cpu"]) == 2
    assert json.loads(capsys.readouterr().out.strip()) == {"error": "native av lib unavailable"}


def test_seed_sweep_f1_rows_equal_jax(tmp_path, capsys):
    theirs_path = tmp_path / "jax.json"
    assert accuracy_seed_sweep.main(["--seeds", "1", "--scenes", "clean", "--backend", "cpu",
                                     "--json", str(theirs_path)]) == 0
    capsys.readouterr()
    assert torch_accuracy_seed_sweep.main(["--seeds", "1", "--scenes", "clean", "--device",
                                           "cpu", "--json", "-"]) == 0
    ours = json.loads(capsys.readouterr().out)
    theirs = json.loads(theirs_path.read_text())
    assert ours["scenes"] == theirs["scenes"]
    assert ours["AVG"] == theirs["AVG"]
    assert ours["overrides"] == theirs["overrides"]
    assert ours["scenes"]["clean"]["seeds"][0]["seed"] == (
        accuracy_seed_sweep.BASE_SEED_OFFSET + zlib.crc32(b"clean") % 97)


@pytest.mark.parametrize("tool, argv", [
    (torch_rpca_fixed_counts, ["--scenes", "1"]),
    (torch_bench_rpca, ["--batch", "1", "--reps", "1"]),
    (torch_mesh_scaling, ["--sizes", "1"]),
    (torch_decode_floor, ["--frames", "63"]),
    (torch_accuracy_seed_sweep, ["--seeds", "1", "--scenes", "clean", "--json", "-"]),
], ids=["rpca_fixed_counts", "bench_rpca", "mesh_scaling", "decode_floor", "seed_sweep"])
def test_tool_raises_for_cuda_without_a_card(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["--device", "cuda"])
