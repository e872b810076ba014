"""Box decoding, projection, clipping, DIoU/smooth-L1, matching and the 3D
IoU of the PyTorch port against the JAX package, on the same numpy inputs.

Tolerances: f32 rounding of the same formulas (1e-6 relative, plus 1e-5
absolute on pixel coordinates of a few hundred px). Matching compares the
total assignment cost, since ties may resolve to different assignments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from vsrd_tpu.models import box_parameters as jbp
from vsrd_tpu.ops import geometry as jgeo, iou2d as jiou, iou3d as jiou3d, matching as jmatch
from vsrd_tpu_torch.models import box_parameters as tbp
from vsrd_tpu_torch.ops import geometry as tgeo, iou2d as tiou, iou3d as tiou3d
from vsrd_tpu_torch.ops import matching as tmatch

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _box_params(n=5):
    return {
        "locations": RNG.normal(size=(n, 3)).astype(np.float32) * 0.5,
        "dimensions": RNG.normal(size=(n, 3)).astype(np.float32),
        "orientations": RNG.normal(size=(n, 2)).astype(np.float32),
        "embeddings": RNG.normal(size=(n, 8)).astype(np.float32),
    }


def test_decode_boxes_matches():
    p = _box_params()
    a = jbp.decode_boxes({k: jnp.asarray(v) for k, v in p.items()})
    b = tbp.decode_boxes({k: torch.from_numpy(v) for k, v in p.items()})
    for key in ("boxes_3d", "locations", "dimensions", "orientations"):
        np.testing.assert_allclose(np.asarray(a[key]), b[key].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_init_box_parameters_layout():
    gen = torch.Generator().manual_seed(0)
    b = tbp.init_box_parameters(gen, 1, 4, 16)
    a = jbp.init_box_parameters(jax.random.PRNGKey(0), 1, 4, 16)
    for key in a:
        assert tuple(b[key].shape) == a[key].shape, key
    np.testing.assert_array_equal(b["orientations"].numpy(), np.asarray(a["orientations"]))
    # one embedding shared by every instance, as in the reference
    assert torch.equal(b["embeddings"][0, 0], b["embeddings"][0, 3])


def test_rotations_match():
    angles = RNG.uniform(-3, 3, size=7).astype(np.float32)
    for jf, tf in ((jgeo.rotation_matrix_x, tgeo.rotation_matrix_x),
                   (jgeo.rotation_matrix_y, tgeo.rotation_matrix_y)):
        np.testing.assert_allclose(np.asarray(jf(jnp.asarray(angles))),
                                   tf(torch.from_numpy(angles)).numpy(), atol=1e-7)


def test_projection_and_clipping_match():
    # boxes in camera space, some straddling or behind the image plane
    corners = RNG.normal(size=(4, 6, 8, 3)).astype(np.float32) * [3, 1, 4] + [0, 0, 4]
    k = np.array([[120, 0, 64], [0, 120, 48], [0, 0, 1]], np.float32)
    ks = np.stack([k, k * [[1.1], [1.1], [1]], k, k]).astype(np.float32)
    ja = jax.vmap(lambda cv, kv: jax.vmap(lambda c: jgeo.project_box_3d(c, kv))(cv))(
        jnp.asarray(corners), jnp.asarray(ks))
    ja = jgeo.clip_boxes_to_image(ja, (96, 128))
    tb = tgeo.clip_boxes_to_image(
        tgeo.project_box_3d(torch.from_numpy(corners), torch.from_numpy(ks)[:, None]), (96, 128))
    np.testing.assert_allclose(np.asarray(ja), tb.numpy(), rtol=1e-6, atol=1e-5)

    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[:, :3, 3] = RNG.normal(size=(2, 3))
    pts = RNG.normal(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jgeo.transform_points(jnp.asarray(mats), jnp.asarray(pts))),
        tgeo.transform_points(torch.from_numpy(mats), torch.from_numpy(pts)).numpy(),
        atol=1e-6)


def test_diou_and_smooth_l1_match():
    def boxes(shape):
        lo = RNG.uniform(0, 50, size=(*shape, 2))
        return np.concatenate([lo, lo + RNG.uniform(1, 40, size=(*shape, 2))], -1).astype(np.float32)

    b1, b2 = boxes((5,)), boxes((6,))
    np.testing.assert_allclose(
        np.asarray(jiou.distance_box_iou(jnp.asarray(b1), jnp.asarray(b2))),
        tiou.distance_box_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
        rtol=1e-6, atol=1e-6)
    e1, e2 = boxes((3, 4)), boxes((3, 4))
    np.testing.assert_allclose(
        np.asarray(jiou.distance_box_iou_loss(jnp.asarray(e1), jnp.asarray(e2))),
        tiou.distance_box_iou_loss(torch.from_numpy(e1), torch.from_numpy(e2)).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jiou.smooth_l1(jnp.asarray(e1), jnp.asarray(e2))),
        tiou.smooth_l1(torch.from_numpy(e1), torch.from_numpy(e2)).numpy(), rtol=1e-6)


@pytest.mark.parametrize("n,num_valid", [(4, 3), (6, 6), (8, 5)])
def test_matching_total_cost_matches(n, num_valid):
    for trial in range(3):
        cost = RNG.normal(size=(n, n)).astype(np.float32)
        valid = np.arange(n) < num_valid
        j = np.asarray(jmatch.masked_linear_sum_assignment(
            jnp.asarray(cost), jnp.asarray(valid), jnp.asarray(valid)))
        t = tmatch.masked_linear_sum_assignment(
            torch.from_numpy(cost), torch.from_numpy(valid), torch.from_numpy(valid)).numpy()
        assert sorted(t.tolist()) == list(range(n))           # a permutation
        rows = np.arange(num_valid)
        r, c = scipy.optimize.linear_sum_assignment(cost[:num_valid, :num_valid])
        best = cost[r, c].sum()
        np.testing.assert_allclose(cost[rows, t[rows]].sum(), best, rtol=1e-5)
        np.testing.assert_allclose(cost[rows, j[rows]].sum(), cost[rows, t[rows]].sum(),
                                   rtol=1e-5)


def test_matching_beyond_eight_is_not_ported():
    with pytest.raises(NotImplementedError):
        tmatch.masked_linear_sum_assignment(torch.zeros(9, 9), torch.ones(9, dtype=torch.bool),
                                            torch.ones(9, dtype=torch.bool))


def test_box_3d_iou_matches():
    def boxes(b):
        # camera-frame boxes (y down), turned z-up as compute_metrics does
        loc = RNG.normal(size=(b, 3)) * [1.5, 0.3, 1.5]
        dims = RNG.uniform(0.5, 2.0, size=(b, 3))
        yaw = RNG.uniform(-1, 1, size=b)
        corners = np.array(jbp.UNIT_BOX_CORNERS)[None] * dims[:, None]
        c, s = np.cos(yaw), np.sin(yaw)
        zero, one = 0 * c, 1 + 0 * c
        rot_y = np.stack([np.stack([c, zero, s], -1), np.stack([zero, one, zero], -1),
                          np.stack([-s, zero, c], -1)], -2)
        cam = corners @ np.swapaxes(rot_y, -1, -2) + loc[:, None]
        rot_x = np.asarray(jgeo.rotation_matrix_x(jnp.asarray(-np.pi / 2)))
        return (cam @ rot_x.T).astype(np.float32)

    c1, c2 = boxes(12), boxes(12)
    c2[:3] = c1[:3]       # identical pairs: collinear clip edges, a degenerate case
    ja3, jab = jax.vmap(jiou3d.box_3d_iou)(jnp.asarray(c1), jnp.asarray(c2))
    ta3, tab = tiou3d.box_3d_iou(torch.from_numpy(c1), torch.from_numpy(c2))
    np.testing.assert_allclose(np.asarray(ja3), ta3.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jab), tab.numpy(), rtol=1e-5, atol=1e-6)
    assert np.all((ta3.numpy() >= 0) & (ta3.numpy() <= 1))
