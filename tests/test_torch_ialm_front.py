"""Port vs JAX package: the fused IALM front (K6).

The plain PyTorch version is held against the Pallas kernel in interpret
mode with the tolerances of tests/test_ialm_front.py (E, M rtol 1e-5,
atol 1e-4; G rtol 1e-4: another summation order), and against the JAX
package's unfused chain at a P the Pallas kernel cannot take.  There G
also gets an absolute floor of 1e-6 max|G|: off-diagonal sums of
random-signed products cancel to values far below max|G|, where any
change of summation order exceeds rtol.  On the CPU
the wrapper takes the plain version; the CUDA kernel is held against it on
the card by chip_smoke.py.  The kernel's register-blocked Gram schedule is
checked here: its pair mapping, and its summation order emulated in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.ops.pallas.ialm_front import TILE
from swiftwatcher_tpu.ops.pallas.ialm_front import ialm_front as jax_ialm_front
from swiftwatcher_tpu_torch.ops.ialm_front import (
    CHUNK,
    KERNEL_THREADS,
    MAX_T,
    front_chain,
    gram_blocks,
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


@pytest.mark.parametrize("T", range(1, MAX_T + 1))
def test_gram_blocks_cover_each_pair_once(T):
    """The kernel's register-blocked Gram: T padded to a multiple of 4 with
    zero rows, and the lower-triangle 4 x 4 blocks (I, J), J <= I, cover
    each pair (i, j), j <= i < T, exactly once (pairs with j > i inside a
    diagonal block and rows past T are computed and never read), and the
    blocks' slices fit the block's threads."""
    tp, blocks, slices = gram_blocks(T)
    assert tp % 4 == 0 and T <= tp < T + 4
    assert slices >= 1 and len(blocks) * slices <= KERNEL_THREADS
    seen = {}
    for I, J in blocks:
        assert J <= I
        for ii in range(4):
            for jj in range(4):
                i, j = 4 * I + ii, 4 * J + jj
                if j <= i < T:
                    seen[(i, j)] = seen.get((i, j), 0) + 1
    assert seen == {(i, j): 1 for i in range(T) for j in range(i + 1)}


def _blocked_gram(M, n_blocks):
    """The kernel's Gram, emulated in f32: per grid block (chunks c with
    c % n_blocks == block), per 4 x 4 block of row pairs and per slice (the
    float4 column groups g of a chunk with g % slices == slice, in order),
    f32 accumulation; then the slices summed in order, then the grid
    blocks in order."""
    B, T, P = M.shape
    tp, blocks, slices = gram_blocks(T)
    n_chunks = -(-P // CHUNK)
    Mp = torch.zeros((B, tp, n_chunks * CHUNK))
    Mp[:, :T, :P] = M
    I = torch.tensor([4 * i for i, _ in blocks])
    J = torch.tensor([4 * j for _, j in blocks])
    rows_i = (I[:, None] + torch.arange(4)).flatten()          # (blocks * 4,)
    rows_j = (J[:, None] + torch.arange(4)).flatten()
    G = torch.zeros((B, T, T))
    for b in range(B):
        partials = []
        for blk in range(n_blocks):
            acc = torch.zeros((len(blocks), slices, 4, 4))
            for c in range(blk, n_chunks, n_blocks):
                chunk = Mp[b, :, c * CHUNK : (c + 1) * CHUNK].reshape(tp, CHUNK // 4, 4)
                for g0 in range(0, CHUNK // 4, slices):
                    g = torch.arange(g0, min(g0 + slices, CHUNK // 4))
                    vi = chunk[rows_i][:, g].reshape(len(blocks), 4, len(g), 4)
                    vj = chunk[rows_j][:, g].reshape(len(blocks), 4, len(g), 4)
                    for q in range(4):       # x, y, z, w in order
                        prod = vi[:, :, :, q].permute(0, 2, 1)[:, :, :, None] * \
                            vj[:, :, :, q].permute(0, 2, 1)[:, :, None, :]
                        acc[:, : len(g)] = acc[:, : len(g)] + prod
            part = torch.zeros((len(blocks), 4, 4))
            for s in range(slices):
                part = part + acc[:, s]
            partials.append(part)
        total = torch.zeros((len(blocks), 4, 4))
        for part in partials:
            total = total + part
        for k, (bi, bj) in enumerate(blocks):
            for ii in range(4):
                for jj in range(4):
                    i, j = 4 * bi + ii, 4 * bj + jj
                    if j <= i < T:
                        G[b, i, j] = G[b, j, i] = total[k, ii, jj]
    return G


@pytest.mark.parametrize("shape,n_blocks", [
    ((2, 21, 4099), 3), ((1, 32, 5000), 2), ((2, 1, 300), 1), ((1, 7, 777), 1),
    ((1, 21, 1), 1), ((1, 13, 2 * CHUNK), 2),
])
def test_blocked_sliced_gram_within_tolerance(rng, shape, n_blocks):
    """The kernel's blocked, sliced Gram summation order, emulated in f32,
    stays within 1e-4 of max|G| of the plain Gram (the tolerance the card's
    check holds K6 to), and is symmetric."""
    X, A, Y, inv_mu = _state(rng, *shape)
    _, M, G0 = ialm_front_reference(*_torch(X, A, Y, inv_mu), LMBDA)
    G = _blocked_gram(M, n_blocks)
    assert torch.equal(G, G.transpose(-1, -2))
    assert float((G - G0).abs().max()) <= 1e-4 * float(G0.abs().max())
    G64 = M.double() @ M.double().transpose(-1, -2)
    assert float((G - G64).abs().max()) <= 1e-4 * float(G64.abs().max())
