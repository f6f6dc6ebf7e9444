"""sharded_localize_windows (BGR crops, the width sharded over 'model') of
the port's mesh on gloo ranks on the CPU, against the JAX package's on the
8-virtual-device CPU mesh and against the port's unsharded
localize_windows (itself against the JAX package's): tables exact, IALM
iterations within 1, at (4, 2) on a width that divides over 'model' and at
(2, 1) on the odd 27 x 61 crop and that width, warm and cold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.parallel import mesh as jax_mesh
from swiftwatcher_tpu.pipeline.window import localize_windows as jax_localize_windows
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.parallel.mesh import sharded_localize_windows
from swiftwatcher_tpu_torch.pipeline.window import localize_windows
from test_torch_mesh import FIELDS, Meshes, _windows, assert_tables_match


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    pool = Meshes()
    yield pool
    pool.close()


def _crops(seed, H, W):
    """BGR crops whose channels differ, so the gray formula matters."""
    gray = _windows(seed, H, W).astype(np.int32)
    return np.stack([gray, np.clip(gray + 7, 0, 255), np.clip(gray - 5, 0, 255)],
                    axis=-1).astype(np.uint8)


CASES = [((4, 2), (32, 64)), ((2, 1), (27, 61)), ((2, 1), (32, 64))]


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("shape, geom", CASES,
                         ids=[f"{s[0]}x{s[1]}-{g[0]}x{g[1]}" for s, g in CASES])
def test_sharded_bgr_matches_jax_and_unsharded(meshes, cpu_devices, shape, geom, warm):
    crops = _crops(99 + geom[1], *geom)
    cfg = dataclasses.replace(DEFAULT_CONFIG, rpca_warm_basis=warm)
    jcfg = dataclasses.replace(JAX_CONFIG, rpca_warm_basis=warm)
    table, iters = sharded_localize_windows(crops, meshes(shape), cfg)
    jm = jax_mesh.make_mesh(shape[0] * shape[1], shape=shape)
    jtable, jiters = jax.jit(
        lambda c: jax_mesh.sharded_localize_windows(c, jm, jcfg))(jnp.asarray(crops))
    table_1, iters_1 = localize_windows(torch.from_numpy(crops), cfg)
    assert_tables_match(table, jtable, table_1, iters, jiters, iters_1)


def test_localize_windows_matches_jax():
    crops = _crops(5, 27, 61)
    table, iters = localize_windows(torch.from_numpy(crops), DEFAULT_CONFIG)
    jtable, jiters = jax_localize_windows(crops, JAX_CONFIG)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(table, f).numpy(), np.asarray(getattr(jtable, f)))
    assert np.abs(iters.numpy() - np.asarray(jiters)).max() <= 1


def test_a_batch_that_does_not_divide_is_refused(meshes):
    with pytest.raises(ValueError, match="B % data == 0"):
        sharded_localize_windows(_crops(3, 27, 61)[:3], meshes((2, 1)), DEFAULT_CONFIG)
