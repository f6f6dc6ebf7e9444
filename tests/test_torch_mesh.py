"""The port's mesh (swiftwatcher_tpu_torch/parallel/mesh.py) on gloo ranks
on the CPU, against the JAX package's mesh on the 8-virtual-device CPU
mesh (tests/test_multichip.py) and against the port's unsharded program.

sharded_localize_windows_gray at (4, 2) and (2, 1), on the odd 27 x 61
crop (P = 1647 does not divide over 'model': the zero padding) and on a
32 x 64 crop, warm and cold: the tables (valid, area, sum_y, sum_x) are
exact and the IALM iterations within 1, the JAX package's own tolerance
(partial Grams summed over ranks round differently from one Gram).  Then
the launcher: a rank that raises and a rank that stalls past the deadline
each fail the run within the deadline and leave no process behind, and a
process holds one mesh at a time."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import make_synthetic_window
from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.parallel import mesh as jax_mesh
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.parallel import mesh as port_mesh
from swiftwatcher_tpu_torch.parallel.mesh import (
    MeshError,
    make_mesh,
    ping,
    sharded_localize_windows_gray,
)
from swiftwatcher_tpu_torch.pipeline.window import localize_windows_gray

FIELDS = ("valid", "area", "sum_y", "sum_x")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for rank 0 (the workers set their own): the
    suite runs in several worker processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Meshes:
    """One open port mesh at a time (a process holds one process group):
    asking for another shape closes the last."""

    def __init__(self):
        self.mesh = None

    def __call__(self, shape):
        m = self.mesh
        if m is None or (m.shape["data"], m.shape["model"]) != shape:
            self.close()
            self.mesh = make_mesh(shape, device="cpu", timeout=120)
        return self.mesh

    def close(self):
        if self.mesh is not None:
            self.mesh.close()
            self.mesh = None


@pytest.fixture(scope="module")
def meshes():
    pool = Meshes()
    yield pool
    pool.close()


def _windows(seed, H, W):
    rng = np.random.default_rng(seed)
    return np.stack([make_synthetic_window(rng, T=21, H=H, W=W, n_dots=1 + k % 2)
                     for k in range(4)])


def assert_tables_match(port, jax_table, unsharded, iters, jax_iters, iters_1):
    for f in FIELDS:
        got = getattr(port, f).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_table, f)), err_msg=f)
        np.testing.assert_array_equal(got, getattr(unsharded, f).numpy(), err_msg=f)
    assert np.abs(iters.numpy() - np.asarray(jax_iters)).max() <= 1
    assert np.abs(iters.numpy() - iters_1.numpy()).max() <= 1


# (data, model) shapes in groups, so each mesh is made once
SHAPES = [(4, 2), (2, 1)]
GEOMS = [(27, 61), (32, 64)]


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_gray_matches_jax_and_unsharded(meshes, cpu_devices, shape, geom, warm):
    gray = _windows(1234 + geom[1], *geom)
    cfg = dataclasses.replace(DEFAULT_CONFIG, rpca_warm_basis=warm)
    jcfg = dataclasses.replace(JAX_CONFIG, rpca_warm_basis=warm)
    table, iters = sharded_localize_windows_gray(gray, meshes(shape), cfg)
    jm = jax_mesh.make_mesh(shape[0] * shape[1], shape=shape)
    jtable, jiters = jax.jit(
        lambda g: jax_mesh.sharded_localize_windows_gray(g, jm, jcfg))(jnp.asarray(gray))
    table_1, iters_1 = localize_windows_gray(torch.from_numpy(gray), cfg)
    assert_tables_match(table, jtable, table_1, iters, jiters, iters_1)


def test_a_batch_that_does_not_divide_is_refused(meshes):
    gray = _windows(7, 27, 61)[:3]
    with pytest.raises(ValueError, match="'data' axis"):
        sharded_localize_windows_gray(gray, meshes((2, 1)), DEFAULT_CONFIG)


def test_one_mesh_per_process(meshes):
    meshes((2, 1))
    with pytest.raises(RuntimeError, match="close the other mesh"):
        make_mesh((1, 2), device="cpu")
    meshes.close()


def test_run_takes_only_functions_of_the_port(meshes):
    with pytest.raises(ValueError, match="function of swiftwatcher_tpu_torch"):
        meshes((2, 1)).run(time.sleep, 0.0)
    assert meshes((2, 1)).run(ping) == 0
    meshes.close()


@pytest.mark.parametrize("delays, what", [
    ([0.0, -1.0, 0.0], "sleep length must be non-negative"),   # rank 1 raises
    ([0.0, 0.0, 600.0], "did not finish within the timeout"),  # rank 2 stalls
], ids=["raises", "stalls"])
def test_a_failed_rank_fails_the_run_and_leaves_no_process(meshes, delays, what):
    meshes.close()
    mesh = make_mesh((1, 3), device="cpu", timeout=120)
    mesh.timeout = 5      # the runs' deadline from here on (the start had 120 s)
    procs = [w.proc for w in mesh._workers]
    t0 = time.monotonic()
    with pytest.raises(MeshError, match=what):
        mesh.run(ping, shards=delays)
    assert time.monotonic() - t0 < 5 + 10
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    with pytest.raises(MeshError, match="closed"):
        mesh.run(ping)
    mesh.close()


def test_a_rank_that_raises_inside_a_collective_unblocks_rank_0(meshes):
    """Rank 1 fails on a bad shard while rank 0 waits for it in the RPCA's
    first norm sum: the run fails at once, with rank 1's traceback."""
    meshes.close()
    mesh = make_mesh((1, 2), device="cpu", timeout=30)
    t0 = time.monotonic()
    with pytest.raises(MeshError, match="rank 1 failed"):
        mesh.run(port_mesh._localize_gray_rank, 3, 3,
                 DEFAULT_CONFIG, False, shards=[np.zeros((1, 21, 5), np.uint8), "bad"])
    assert time.monotonic() - t0 < 20
    mesh.close()
