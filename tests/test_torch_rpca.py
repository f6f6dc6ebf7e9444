"""Port vs JAX package: batched IALM RPCA, warm basis and cold start.

Tolerances (the same for both solvers):
  * rpca_dtype="float64" (JAX under x64): iteration counts equal, uint8
    motion bit-equal;
  * the shipped f32 solver with bf16 A/E/Y: iteration counts within +-1 and
    uint8 motion within +-3 (PARITY deviations 3 and 8), with >= 99.9% of
    pixels within +-1 — the two frameworks sum in different orders.
"""

import dataclasses

import jax
import numpy as np
import torch

from swiftwatcher_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from swiftwatcher_tpu.ops.rpca import rpca_motion_window_batched as jax_rpca
from swiftwatcher_tpu_torch.config import DEFAULT_CONFIG
from swiftwatcher_tpu_torch.ops.rpca import (
    ialm_gates_and_kwargs,
    rpca_motion_window_batched,
)

from oracles import make_synthetic_window


def _windows(rng, B=2, T=21, H=24, W=32):
    return np.stack([make_synthetic_window(rng, T=T, H=H, W=W) for _ in range(B)])


def _configs(**overrides):
    """(port config, JAX config) with the same overrides."""
    return (dataclasses.replace(DEFAULT_CONFIG, **overrides),
            dataclasses.replace(JAX_CONFIG, **overrides))


def test_rpca_f64_iters_equal_motion_bit_equal(rng):
    cfg, jcfg = _configs(rpca_dtype="float64")
    wins = _windows(rng)
    with jax.enable_x64(True):
        jm, ji = jax_rpca(wins, jcfg)
        jm, ji = np.asarray(jm), np.asarray(ji)
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), cfg)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(m.numpy(), jm)


def test_rpca_cold_f64_iters_equal_motion_bit_equal(rng):
    cfg, jcfg = _configs(rpca_dtype="float64", rpca_warm_basis=False)
    wins = _windows(rng)
    with jax.enable_x64(True):
        jm, ji = jax_rpca(wins, jcfg)
        jm, ji = np.asarray(jm), np.asarray(ji)
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), cfg)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(m.numpy(), jm)


def _assert_within_envelope(m, i, jm, ji):
    jm = np.asarray(jm).astype(int)
    assert np.abs(i.numpy().astype(int) - np.asarray(ji)).max() <= 1
    diff = np.abs(m.numpy().astype(int) - jm)
    assert diff.max() <= 3
    assert (diff <= 1).mean() >= 0.999
    assert (m.numpy() > 50).sum() > 0          # the dark dots show as motion


def test_rpca_shipped_f32_bf16_within_envelope(rng):
    wins = _windows(rng, B=3)
    jm, ji = jax_rpca(wins, JAX_CONFIG)
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), DEFAULT_CONFIG)
    _assert_within_envelope(m, i, jm, ji)


def test_rpca_cold_f32_bf16_within_envelope(rng):
    cfg, jcfg = _configs(rpca_warm_basis=False)
    wins = _windows(rng, B=3)
    jm, ji = jax_rpca(wins, jcfg)
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), cfg)
    _assert_within_envelope(m, i, jm, ji)


def test_rpca_fixed_iters_at_the_dynamic_count(rng):
    """The fixed-trip branch equals the dynamic loop bit for bit when every
    window's dynamic count is the fixed count, as in the JAX package."""
    wins = _windows(rng, B=3)
    m0, i0 = rpca_motion_window_batched(torch.from_numpy(wins), DEFAULT_CONFIG)
    assert len(set(i0.tolist())) == 1
    cfg, jcfg = _configs(rpca_fixed_iters=int(i0[0]))
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), cfg)
    assert torch.equal(i, i0) and torch.equal(m, m0)
    jm, ji = jax_rpca(wins, jcfg)
    _assert_within_envelope(m, i, jm, ji)


def test_rpca_cold_fixed_iters_at_the_dynamic_count(rng):
    cold, _ = _configs(rpca_warm_basis=False)
    wins = _windows(rng, B=3)
    m0, i0 = rpca_motion_window_batched(torch.from_numpy(wins), cold)
    assert len(set(i0.tolist())) == 1
    cfg = dataclasses.replace(cold, rpca_fixed_iters=int(i0[0]))
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), cfg)
    assert torch.equal(i, i0) and torch.equal(m, m0)


def test_rpca_all_zero_window(rng):
    wins = _windows(rng, B=2)
    wins[1] = 0
    jm, ji = jax_rpca(wins, JAX_CONFIG)
    m, i = rpca_motion_window_batched(torch.from_numpy(wins), DEFAULT_CONFIG)
    assert int(i[1]) == int(ji[1])
    assert not m[1].any() and not np.asarray(jm)[1].any()


def test_rpca_gates():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    kw = ialm_gates_and_kwargs(DEFAULT_CONFIG, torch.float32, cpu)
    assert kw["x_store_dtype"] == "uint8"
    assert kw["store_y_dtype"] == kw["store_ae_dtype"] == "bfloat16"
    assert kw["warm_basis"] and not kw["fused_front"]
    assert ialm_gates_and_kwargs(DEFAULT_CONFIG, torch.float64, cpu)["store_y_dtype"] is None
    # the cold gate: K6 on a CUDA f32 solve only, X still held as u8
    cold = dataclasses.replace(DEFAULT_CONFIG, rpca_warm_basis=False)
    kw = ialm_gates_and_kwargs(cold, torch.float32, cuda)
    assert kw["fused_front"] and not kw["warm_basis"]
    assert kw["x_store_dtype"] == "uint8" and kw["store_ae_dtype"] == "bfloat16"
    assert not ialm_gates_and_kwargs(cold, torch.float32, cpu)["fused_front"]
    assert not ialm_gates_and_kwargs(cold, torch.float64, cuda)["fused_front"]
    assert not ialm_gates_and_kwargs(
        dataclasses.replace(cold, use_pallas_rpca=False), torch.float32, cuda)["fused_front"]
    assert not ialm_gates_and_kwargs(DEFAULT_CONFIG, torch.float32, cuda)["fused_front"]
