"""Port vs JAX package: the fused IALM front (K6).

The plain PyTorch version is held against the Pallas kernel in interpret
mode with the tolerances of tests/test_ialm_front.py (E, M rtol 1e-5,
atol 1e-4; G rtol 1e-4: another summation order), and against the JAX
package's unfused chain at a P the Pallas kernel cannot take.  There G
also gets an absolute floor of 1e-6 max|G|: off-diagonal sums of
random-signed products cancel to values far below max|G|, where any
change of summation order exceeds rtol.  On the CPU
the wrapper takes the plain version; the CUDA kernel is held against it on
the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.ops.pallas.ialm_front import TILE
from swiftwatcher_tpu.ops.pallas.ialm_front import ialm_front as jax_ialm_front
from swiftwatcher_tpu_torch.ops.ialm_front import (
    front_chain,
    ialm_front,
    ialm_front_reference,
)

LMBDA = 0.01


def _state(rng, B, T, P):
    X = rng.standard_normal((B, T, P)).astype(np.float32) * 100
    A = rng.standard_normal((B, T, P)).astype(np.float32) * 50
    Y = rng.standard_normal((B, T, P)).astype(np.float32)
    inv_mu = rng.uniform(0.1, 100.0, size=(B,)).astype(np.float32)
    return X, A, Y, inv_mu


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_close(ours, theirs, g_floor=0.0):
    E, M, G = (t.numpy() for t in ours)
    E0, M0, G0 = (np.asarray(t) for t in theirs)
    np.testing.assert_allclose(E, E0, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(M, M0, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(G, G0, rtol=1e-4, atol=g_floor * np.abs(G0).max())


def test_reference_vs_pallas_interpret(rng):
    state = _state(rng, 3, 21, 2 * TILE)
    theirs = jax_ialm_front(*state, LMBDA, interpret=True)
    _assert_close(ialm_front_reference(*_torch(*state), LMBDA), theirs)


@jax.jit
def _xla_chain(x, a, y, im):
    im = im[:, None, None]
    eraw = x - a + im * y
    e = jnp.maximum(eraw - LMBDA * im, 0.0) + jnp.minimum(eraw + LMBDA * im, 0.0)
    m = x - e + im * y
    return e, m, jnp.einsum("btp,bsp->bts", m, m)


@pytest.mark.parametrize("shape", [(2, 21, 1000), (1, 21, 1), (3, 7, 257)])
def test_reference_vs_unfused_chain_unpadded(rng, shape):
    """No padding: any P, as the CUDA kernel takes it."""
    state = _state(rng, *shape)
    _assert_close(ialm_front_reference(*_torch(*state), LMBDA), _xla_chain(*state),
                  g_floor=1e-6)


def test_wrapper_on_cpu_is_the_reference(rng):
    state = _torch(*_state(rng, 2, 21, 300))
    for a, b in zip(ialm_front(*state, LMBDA), ialm_front_reference(*state, LMBDA)):
        assert torch.equal(a, b)


def test_stored_operands_widen_exactly(rng):
    """u8 X and bf16 A, Y (how the solver holds them) give the front of
    their f32 widenings, bit for bit."""
    X = torch.from_numpy(rng.integers(0, 256, size=(2, 21, 500)).astype(np.uint8))
    A = torch.from_numpy(rng.standard_normal((2, 21, 500)).astype(np.float32) * 50).bfloat16()
    Y = torch.from_numpy(rng.standard_normal((2, 21, 500)).astype(np.float32)).bfloat16()
    inv_mu = torch.tensor([3.0, 40.0])
    got = ialm_front(X, A, Y, inv_mu, LMBDA)
    want = ialm_front_reference(X.float(), A.float(), Y.float(), inv_mu, LMBDA)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    E, M = front_chain(X, A, Y, inv_mu, LMBDA)
    assert torch.equal(E, got[0]) and torch.equal(M, got[1])
    assert torch.equal(got[2], got[2].transpose(-1, -2))
