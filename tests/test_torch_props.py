"""Port vs JAX package: region tables (bit-equal), at the FAST_LABELS
boundary and with uint8 label aliasing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftwatcher_tpu.ops.ccl import label_components as jax_label_components
from swiftwatcher_tpu.ops.ccl import wrap_labels_uint8 as jax_wrap
from swiftwatcher_tpu.ops.props import region_tables as jax_region_tables
from swiftwatcher_tpu_torch.ops.props import FAST_LABELS, MAX_LABELS, region_tables
from swiftwatcher_tpu_torch.pipeline.runner import frame_centroids

FIELDS = ("area", "sum_y", "sum_x", "min_y", "min_x", "max_y", "max_x", "valid")


def _assert_tables_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)


def _labels_up_to(rng, top, T=3, H=40, W=50):
    lab = rng.integers(0, top + 1, size=(T, H, W)).astype(np.uint8)
    lab[:, :5] = 0
    lab[0, 1, 1] = top     # every batch holds its top label
    return lab


@pytest.mark.parametrize("top", [FAST_LABELS - 1, FAST_LABELS, 255])
@pytest.mark.parametrize("with_bbox", [True, False])
def test_region_tables_fast_label_boundary(rng, top, with_bbox):
    lab = _labels_up_to(rng, top)
    want = jax_region_tables(jnp.asarray(lab), with_bbox=with_bbox)
    got = region_tables(torch.from_numpy(lab), with_bbox=with_bbox)
    _assert_tables_equal(got, want)
    assert got.area.shape == (3, MAX_LABELS)


def test_region_tables_uint8_aliasing(rng):
    """300 isolated components: labels 256..300 wrap onto 0..44, and label
    256 collapses into the background slot."""
    fg = np.zeros((1, 60, 40), bool)
    fg[0, ::3, ::3] = True
    fg[0, 57:, :] = False
    fg[0, 54, 36:] = False
    jlab, _ = jax_label_components(jnp.asarray(fg), use_pallas=False)
    lab_u8 = np.array(jax_wrap(jlab))
    want = jax_region_tables(jnp.asarray(lab_u8))
    got = region_tables(torch.from_numpy(lab_u8))
    _assert_tables_equal(got, want)
    assert int(np.asarray(jlab).max()) > 256


def test_region_tables_unbatched_and_centroids(rng):
    """Centroids as the runner reads them (`frame_centroids`, float64 from
    exact sums) against the JAX table's f32 centroids: rtol 1e-6."""
    lab = _labels_up_to(rng, 7, T=1)[0]
    want = jax_region_tables(jnp.asarray(lab))
    got = region_tables(torch.from_numpy(lab))
    _assert_tables_equal(got, want)
    host = got.map(lambda a: a[None, None].numpy())
    cents = np.array(frame_centroids(host, 0, 0))
    valid = np.asarray(want.valid)
    assert len(cents) == int(want.num_segments)
    np.testing.assert_allclose(cents[:, 0], np.asarray(want.centroid_y)[valid], rtol=1e-6)
    np.testing.assert_allclose(cents[:, 1], np.asarray(want.centroid_x)[valid], rtol=1e-6)
