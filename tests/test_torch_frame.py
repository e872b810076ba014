"""The PyTorch port's frame building against the JAX package's.

``synthetic_frame`` is host numpy in both packages; from the same integer
seed (the one the JAX package draws from its key) the frames must be
bit-identical, and ``ray_directions_at`` must agree to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import frame as jfm
from vsrd_tpu_torch.pipeline import frame as tfm

torch.set_num_threads(2)

FIELDS = (
    "soft_masks_flat", "sampling_weights", "candidate_indices", "candidate_weights",
    "intrinsics", "extrinsics", "inv_projections", "camera_positions", "gt_boxes_2d",
    "visible", "valid", "gt_boxes_3d", "rectification",
)


def _frames(layout="compact", **kwargs):
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    jf = jfm.synthetic_frame(key, layout=layout, **kwargs)
    tf = tfm.synthetic_frame(seed, layout=layout, **kwargs, device="cpu")
    return jf, tf


@pytest.mark.parametrize("layout,kwargs", [
    ("compact", dict(num_views=3, image_size=(48, 64), num_instances=3, max_instances=4)),
    # fewer candidates than pixels: exercises the seeded tie-break + sort
    ("kitti", dict(num_views=2, image_size=(40, 56), num_instances=2, max_instances=3,
                   num_candidates=1000)),
])
def test_synthetic_frame_is_bit_identical(layout, kwargs):
    jf, tf = _frames(layout, **kwargs)
    assert tf.image_size == jf.image_size
    assert tf.target_index == int(jf.target_index)
    assert tf.soft_masks_flat.dtype == torch.bfloat16
    for name in FIELDS:
        a = np.asarray(getattr(jf, name))
        b = getattr(tf, name)
        b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        a = a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_synthetic_frame_with_images_matches():
    jf, tf = _frames(num_views=2, image_size=(32, 40), with_images=True)
    np.testing.assert_array_equal(np.asarray(jf.gray_images), tf.gray_images.numpy())


def test_ray_directions_at_matches():
    jf, tf = _frames(num_views=3, image_size=(48, 64))
    idx = np.random.default_rng(0).integers(0, 3 * 48 * 64, size=64)
    o1, d1 = jfm.ray_directions_at(jf, jnp.asarray(idx, jnp.int32))
    o2, d2 = tfm.ray_directions_at(tf, torch.as_tensor(idx))
    np.testing.assert_array_equal(np.asarray(o1), o2.numpy())
    # unit directions, f32 rounding of the same mul + reduce
    np.testing.assert_allclose(np.asarray(d1), d2.numpy(), rtol=0, atol=1e-7)
