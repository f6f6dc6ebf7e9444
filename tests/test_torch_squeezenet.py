"""The port's SqueezeNet (swiftwatcher_tpu_torch/models/squeezenet.py) vs the
JAX package's on the CPU: logits within rtol=2e-4, atol=2e-4 (the JAX
package's own tolerance against a torch oracle, tests/test_squeezenet.py)
with equal argmaxes, on seeded random weights and on the shipped ones; the
weights carried across both ways; the ceil-mode pools' shapes and values;
the shipped weights file identical to the JAX package's."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.models import classifier as jax_classifier
from swiftwatcher_tpu.models import squeezenet as jax_squeezenet
from swiftwatcher_tpu_torch.models import classifier, squeezenet

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _shipped():
    with np.load(jax_classifier.DEFAULT_WEIGHTS) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_random_params_vs_jax(seed):
    params = jax_squeezenet.random_params(np.random.default_rng(seed))
    ours_params = squeezenet.random_params(np.random.default_rng(seed))
    x = np.random.default_rng(100 + seed).standard_normal((3, 224, 224, 3)).astype(np.float32)
    theirs = np.asarray(jax_squeezenet.forward(params, jnp.asarray(x)))
    ours = squeezenet.forward(ours_params, _nchw(x)).numpy()
    assert ours.shape == theirs.shape == (3, 2)
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_array_equal(ours.argmax(1), theirs.argmax(1))
    np.testing.assert_array_equal(squeezenet.predict(ours_params, _nchw(x)).numpy(),
                                  theirs.argmax(1))


def test_forward_shipped_weights_vs_jax(rng):
    params = _shipped()
    x = rng.standard_normal((3, 224, 224, 3)).astype(np.float32)
    theirs = np.asarray(jax_squeezenet.forward(params, jnp.asarray(x)))
    ours = squeezenet.forward(squeezenet.params_from_jax(params), _nchw(x)).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_array_equal(ours.argmax(1), theirs.argmax(1))


def test_random_params_are_the_jax_draws_carried_across():
    theirs = jax_squeezenet.random_params(np.random.default_rng(7), num_classes=3)
    ours = squeezenet.random_params(np.random.default_rng(7), num_classes=3)
    assert sorted(ours) == sorted(theirs) and len(ours) == 52
    for k, v in squeezenet.params_to_jax(ours).items():
        np.testing.assert_array_equal(v, theirs[k])
    assert ours["features.0.weight"].shape == (96, 3, 7, 7)
    assert ours["classifier.1.weight"].shape == (3, 512, 1, 1)


def test_params_from_jax_round_trips():
    params = _shipped()
    state = squeezenet.params_from_jax(params)
    for k, v in params.items():
        t = state[k]
        assert t.dtype == torch.float32 and t.is_contiguous()
        if v.ndim == 4:
            # HWIO -> OIHW
            assert tuple(t.shape) == (v.shape[3], v.shape[2], v.shape[0], v.shape[1])
    back = squeezenet.params_to_jax(state)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    # the JAX package's own torch -> HWIO conversion inverts it too
    conv = jax_squeezenet.convert_torch_state_dict({k: t.numpy() for k, t in state.items()})
    for k, v in params.items():
        np.testing.assert_array_equal(conv[k], v)


@pytest.mark.parametrize("hw", [224, 109, 54, 27, 13, 8, 4])
def test_ceil_pool_shapes_and_values_vs_jax(hw, rng):
    x = rng.standard_normal((2, hw, hw + 1, 5)).astype(np.float32)
    theirs = np.asarray(jax_squeezenet._maxpool_ceil(jnp.asarray(x)))
    ours = torch.nn.functional.max_pool2d(_nchw(x), 3, stride=2, ceil_mode=True)
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_weights_file_is_the_jax_packages():
    ours = classifier.DEFAULT_WEIGHTS.read_bytes()
    theirs = jax_classifier.DEFAULT_WEIGHTS.read_bytes()
    assert len(ours) == 2960478
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest()


def test_expand_bbox_matches_jax(rng):
    assert classifier.expand_bbox([5, 5, 15, 12], (24, 24)) == [-2, -3, 22, 21]
    for _ in range(200):
        y1, x1 = rng.integers(-5, 200, 2)
        h, w = rng.integers(0, 40, 2)
        box = [int(y1), int(x1), int(y1 + h), int(x1 + w)]
        size = tuple(int(v) for v in rng.integers(1, 40, 2))
        assert classifier.expand_bbox(box, size) == jax_classifier.expand_bbox(box, size)
