"""The port's solve_lap (plain PyTorch JV) vs the JAX package's and scipy:
equal col4row on the same float32 matrices, with and without the padding
rows' `skip`, and scipy's optimal cost."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from swiftwatcher_tpu.ops.hungarian import solve_lap as jax_solve_lap
from swiftwatcher_tpu_torch.ops.hungarian import solve_lap


def _both(cost, skip=None):
    ours = solve_lap(torch.from_numpy(cost), None if skip is None else torch.from_numpy(skip))
    theirs = np.asarray(jax_solve_lap(cost) if skip is None else jax_solve_lap(cost, skip=skip))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    return ours.numpy()


def _optimal(cost, col4row, rtol):
    rows, cols = linear_sum_assignment(cost.astype(np.float64))
    assert sorted(col4row.tolist()) == list(range(len(cost)))
    np.testing.assert_allclose(cost[np.arange(len(cost)), col4row].astype(np.float64).sum(),
                               cost[rows, cols].astype(np.float64).sum(), rtol=rtol)


@pytest.mark.parametrize("n", [1, 2, 5, 12, 24, 48])
def test_random_matrices_equal_jax_and_optimal(rng, n):
    for _ in range(4):
        cost = rng.random((n, n)).astype(np.float32) * 10
        _optimal(cost, _both(cost), 1e-5)


def _tracking_matrix(rng, K, n_prev, n_curr, snap=False):
    """The device tracker's padded 2K x 2K layout: filler 1 + eps between
    valid slots, a random match block, diagonal 1 (valid) or 0 (padding),
    1e9 against padding; `snap` draws the match block from few values, so
    ties occur."""
    pv = np.zeros(K, bool)
    pv[rng.choice(K, n_prev, replace=False)] = True
    cv = np.zeros(K, bool)
    cv[rng.choice(K, n_curr, replace=False)] = True
    rv = np.concatenate([pv, cv])
    cost = np.where(rv[:, None] & rv[None, :], 1.0 + 1.19e-7, 1e9).astype(np.float32)
    match = rng.random((K, K)) * 2
    if snap:
        match = np.floor(match * 4) / 4
    cost[:K, K:] = np.where(pv[:, None] & cv[None, :], match.astype(np.float32), cost[:K, K:])
    np.fill_diagonal(cost, np.where(rv, 1.0, 0.0).astype(np.float32))
    return cost, ~rv


@pytest.mark.parametrize("K, snap", [(4, False), (12, False), (24, False), (12, True)])
def test_skip_equals_jax_and_the_full_solve(rng, K, snap):
    for _ in range(6):
        n_prev, n_curr = (int(x) for x in rng.integers(0, K + 1, size=2))
        cost, skip = _tracking_matrix(rng, K, n_prev, n_curr, snap)
        skipped = _both(cost, skip)
        np.testing.assert_array_equal(skipped, _both(cost))
        _optimal(cost, skipped, 1e-5)


def test_identity_on_tracking_structure():
    """No matches: every segment sits on its diagonal."""
    cost = np.ones((10, 10), np.float32) + np.float32(1e-6)
    np.fill_diagonal(cost, 1.0)
    np.testing.assert_array_equal(_both(cost), np.arange(10))


def test_tracking_like_matrix():
    """2 previous, 3 current slots: the two forced matches are found."""
    n_prev, n = 2, 5
    cost = np.ones((n, n), np.float64) + 2.2e-16
    cost[0, n_prev + 1] = 0.01
    cost[1, n_prev + 0] = 0.9
    np.fill_diagonal(cost, 1.0)
    ours = _both(cost.astype(np.float32))
    assert ours[0] == n_prev + 1 and ours[1] == n_prev + 0
    _optimal(cost.astype(np.float32), ours, 1e-6)


def test_large_finite_blocks():
    """Big "impossible" cells keep every row on its diagonal, even beside
    cheap match cells (why the tracker's filler is 1 + eps, not big)."""
    n = 16
    cost = np.full((n, n), 1e6, np.float32)
    np.fill_diagonal(cost, 1.0)
    for k in range(4):
        cost[k, 8 + k] = 0.1
    np.testing.assert_array_equal(_both(cost), np.arange(n))


def test_all_rows_skipped_is_the_identity():
    cost = np.full((6, 6), 1e9, np.float32)
    np.fill_diagonal(cost, 0.0)
    np.testing.assert_array_equal(_both(cost, np.ones(6, bool)), np.arange(6))
