"""The classifier fine-tune (swiftwatcher_tpu_torch/models/train.py) and the
dp x tp sharded train step (parallel/mesh.py) against the JAX package's
models/train.py and parallel/mesh.py on the CPU.

Tolerances: features, the loss and the gradients differ by rounding only
(another convolution and reduction order): rtol 1e-5.  One Adam step from
an equal, non-trivial state (count 3, moments well away from zero) is a
smooth function of the gradients, so the updated head agrees within 1e-7
(lr 1e-3).  Over several steps from a fresh state, Adam's first step moves
each weight by about lr * sign(g): an element whose gradient is within
rounding of zero could move 2 lr apart.  So the fine-tune's comparison
first checks that both packages' first gradients have the same sign
everywhere, and the sharded step's from a fresh state that every first
gradient is exactly zero (a ReLU off for the whole batch, in both) or at
least 1e-5 in magnitude (100 times the rounding of the sums over 512
channels); then the heads are held within 1e-6.  The sharded step sums the
head conv over 'model' and averages the gradients over 'data', another
summation order: its losses within 1e-5 of the unsharded port step's."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swiftwatcher_tpu.models import train as jax_train
from swiftwatcher_tpu.models.squeezenet import random_params as jax_random_params
from swiftwatcher_tpu_torch.models import train
from swiftwatcher_tpu_torch.models.squeezenet import params_from_jax, params_to_jax
from swiftwatcher_tpu_torch.parallel.mesh import (
    gather_head,
    init_sharded_training,
    make_mesh,
)

HEAD = train.HEAD_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_random_params(np.random.default_rng(5))


def _feats(seed, n=8, hw=3):
    """Two classes separable in feature space (tests/test_multichip.py):
    NHWC for the JAX package, (N, 512, h, w) for the port."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, hw, hw, 512)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats[labels == 1, :, :, :64] += 3.0
    return feats, labels, torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous()


def _port_head(jax_params):
    _, head = train.split_params(params_from_jax(jax_params))
    return head


def _grads(head, feats_t, labels):
    h = {k: v.detach().clone().requires_grad_(True) for k, v in head.items()}
    loss = train.loss_fn(h, feats_t, torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in h.items()}


def _smallest_nonzero(grads):
    """The smallest |g| over the gradients that are not exactly zero (a
    head channel whose ReLU is off for the whole batch gets zeros in both
    packages, and Adam leaves its weights where they are)."""
    return min(float(v[v != 0].abs().min()) for v in grads.values())


def test_features_match_jax(jax_params):
    x = np.random.default_rng(0).standard_normal((2, 224, 224, 3)).astype(np.float32)
    trunk, _ = jax_train.split_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.asarray(jax_train.features(trunk, jnp.asarray(x))).transpose(0, 3, 1, 2)
    ptrunk, _ = train.split_params(params_from_jax(jax_params))
    got = train.features(ptrunk, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (2, 512, 13, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_loss_and_gradients_match_jax(jax_params):
    feats, labels, feats_t = _feats(1)
    _, jhead = jax_train.split_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    jloss, jgrads = jax.value_and_grad(jax_train.loss_fn)(jhead, jnp.asarray(feats),
                                                          jnp.asarray(labels))
    loss, grads = _grads(_port_head(jax_params), feats_t, labels)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = params_to_jax(grads)
    for k in HEAD:
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(grads[k], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_one_adam_step_from_an_equal_state_matches_jax(jax_params):
    """optax.adam and torch's Adam, both after 3 steps with the same
    moments: the step's head and moments agree, and the state carries both
    ways."""
    feats, labels, feats_t = _feats(2)
    rng = np.random.default_rng(3)
    _, jhead = jax_train.split_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    mu = {k: (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
          for k, v in jhead.items()}
    nu = {k: (np.abs(rng.standard_normal(np.shape(v))) * 1e-3 + 1e-4).astype(np.float32)
          for k, v in jhead.items()}
    opt = optax.adam(1e-3)
    adam, rest = opt.init(jhead)
    jstate = (adam._replace(count=jnp.asarray(3, jnp.int32),
                            mu={k: jnp.asarray(v) for k, v in mu.items()},
                            nu={k: jnp.asarray(v) for k, v in nu.items()}), rest)
    jhead2, jstate2, jloss = jax_train.make_train_step(opt)(
        jhead, jstate, jnp.asarray(feats), jnp.asarray(labels))

    head = _port_head(jax_params)
    popt = train.make_optimizer(head, 1e-3)
    train.adam_state_from_optax(popt, head, 3, mu, nu)
    head, popt, loss = train.make_train_step()(head, popt, feats_t, torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = params_to_jax({k: v.detach() for k, v in head.items()})
    for k in HEAD:
        np.testing.assert_allclose(got[k], np.asarray(jhead2[k]), rtol=0, atol=1e-7)
    count, pmu, pnu = train.adam_state_to_optax(popt, head)
    assert count == int(jstate2[0].count) == 4
    # the moments take (1 - b1) g and (1 - b2) g^2: the gradients' rounding
    # (1e-5 of max|g|, about 0.2 here) scaled by those factors
    for k in HEAD:
        np.testing.assert_allclose(pmu[k], np.asarray(jstate2[0].mu[k]), rtol=1e-5, atol=2e-7)
        np.testing.assert_allclose(pnu[k], np.asarray(jstate2[0].nu[k]), rtol=1e-5, atol=1e-9)


def test_finetune_matches_jax(jax_params):
    """Three steps on batches of 4 of 6 random 224 x 224 images, drawn from
    the same seed by both: the trunk unchanged, the head within 1e-6."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((6, 224, 224, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    want = jax_train.finetune(jax_params, images, labels, steps=3, batch_size=4, lr=1e-3,
                              seed=7)
    params = params_from_jax(jax_params)
    # the premise of the tolerance: on the first batch, each package's
    # gradient of every weight has the same sign
    idx = np.random.default_rng(7).integers(0, 6, size=4)
    trunk, head = train.split_params(params)
    with torch.no_grad():
        f = train.features(trunk, torch.from_numpy(images[idx]).permute(0, 3, 1, 2).contiguous())
    g = params_to_jax(_grads(head, f, labels[idx])[1])
    jtrunk, jhead = jax_train.split_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    jg = jax.grad(jax_train.loss_fn)(jhead, jax_train.features(jtrunk, jnp.asarray(images[idx])),
                                     jnp.asarray(labels[idx]))
    for k in HEAD:
        np.testing.assert_array_equal(np.sign(g[k]), np.sign(np.asarray(jg[k])))
    got = params_to_jax({k: torch.from_numpy(v) for k, v in train.finetune(
        params, images, labels, steps=3, batch_size=4, lr=1e-3, seed=7, device="cpu").items()})
    assert sorted(got) == sorted(want)
    for k in want:
        if k in HEAD:
            assert np.abs(want[k] - jax_params[k]).max() > 1e-3       # it trained
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((2, 2), device="cpu", timeout=120) as m:
        yield m


def test_sharded_train_step_learns(mesh, jax_params):
    """tests/test_multichip.py's criterion on the port's (2, 2) mesh (dp
    and tp both)."""
    trunk, head, opt_state, step, place = init_sharded_training(
        mesh, params_from_jax(jax_params), lr=1e-2)
    _, labels, feats_t = _feats(0, n=8, hw=2)
    head, opt_state, feats_d, labels_d = place(head, opt_state, feats_t, labels)
    losses = []
    for _ in range(30):
        head, opt_state, loss = step(head, opt_state, feats_d, labels_d)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert losses[-1] < 0.2


@pytest.mark.parametrize("from_state", [False, True], ids=["fresh", "after-3-steps"])
def test_sharded_train_step_matches_the_unsharded_step(mesh, jax_params, from_state):
    """Five steps on the (2, 2) mesh and on one process from the same head
    and Adam state: the losses (the global batch mean) and the head agree."""
    _, labels, feats_t = _feats(6, n=8, hw=3)
    params = params_from_jax(jax_params)
    _, head = train.split_params(params)
    opt = train.make_optimizer(head, 1e-3)
    unsharded = train.make_train_step()
    if from_state:
        for _ in range(3):
            unsharded(head, opt, feats_t, torch.from_numpy(labels))
    else:
        _, g = _grads(head, feats_t, labels)
        assert _smallest_nonzero(g) >= 1e-5
    _, _, _, step, place = init_sharded_training(mesh, params, lr=1e-3)
    placed = place(head, opt, feats_t, labels)
    want_losses = []
    for _ in range(5):
        head, opt, loss = unsharded(head, opt, feats_t, torch.from_numpy(labels))
        want_losses.append(float(loss))
    losses = []
    for _ in range(5):
        _, _, loss = step(*placed)
        losses.append(loss)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = gather_head(placed[0])
    for k in HEAD:
        np.testing.assert_allclose(got[k].numpy(), head[k].detach().numpy(), rtol=0, atol=1e-6)


def test_place_refuses_a_batch_that_does_not_divide(mesh, jax_params):
    _, _, _, _, place = init_sharded_training(mesh, params_from_jax(jax_params))
    _, labels, feats_t = _feats(0, n=5)
    with pytest.raises(ValueError, match="divisible by data=2"):
        place(_port_head(jax_params), None, feats_t, labels)
