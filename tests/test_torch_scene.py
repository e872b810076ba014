"""The port's scene fields, hard union, grid sampling and surface functions
against the JAX package's, on the same numpy-seeded inputs in f32.

Tolerances: the scene fields 2e-6 absolute plus 2e-7 relative (the same
f32 arithmetic in another order; distances reach 15 m, where an ulp is
1e-6); grid sampling and its gradient with respect to the grid
1e-5; the march's positions 1e-4 m with ``converged`` equal (the steps
are sums of f32 distances, and a ray only flips its convergence where its
deciding |sd| lies at the criterion); normals 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.ops import grid_sample as jgs
from vsrd_tpu.rendering import renderer as jrenderer, scene as jscene, sdf as jsdf
from vsrd_tpu_torch.ops import grid_sample as tgs
from vsrd_tpu_torch.rendering import renderer as trenderer, scene as tscene, sdf as tsdf

torch.set_num_threads(2)
TAU = 0.5
NUM_WEIGHTS = 1617


def _scene_inputs(n=4, valid=(1, 1, 1, 0), seed=0, spread=3.0, depth=0.0):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1, 1, n)
    loc = rng.normal(size=(n, 3)) * spread + np.array([0.0, 0.0, depth])
    rot = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                    for a in angles])
    half = rng.uniform(0.5, 2.0, size=(n, 3))
    w = rng.normal(size=(n, NUM_WEIGHTS)) * 0.3
    # instance 1 is a copy of instance 0: a tie everywhere
    loc[1], rot[1], half[1], w[1] = loc[0], rot[0], half[0], w[0]
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return dict(loc=f32(loc), rot=f32(rot), half=f32(half), valid=np.asarray(valid, bool),
                w=f32(w))


def _scenes(x, use_rdf):
    j = jscene.SceneParams(locations=jnp.asarray(x["loc"]), rotations=jnp.asarray(x["rot"]),
                           half_dimensions=jnp.asarray(x["half"]),
                           valid=jnp.asarray(x["valid"]),
                           field_weights=jnp.asarray(x["w"]) if use_rdf else None)
    t = tscene.SceneParams(torch.from_numpy(x["loc"]), torch.from_numpy(x["rot"]),
                           torch.from_numpy(x["half"]), torch.from_numpy(x["valid"]),
                           torch.from_numpy(x["w"]) if use_rdf else None)
    return j, t


def _points(p=64, seed=1, scale=5.0):
    return np.random.default_rng(seed).normal(size=(p, 3)).astype(np.float32) * scale


@pytest.mark.parametrize("use_rdf", [False, True])
def test_scene_fields_match_jax(use_rdf):
    """Soft and hard unions, with a tie (instances 0 and 1 are equal, so
    the hard union's one-hot goes to 0 as argmin's does) and a padded
    instance."""
    x = _scene_inputs()
    js, ts = _scenes(x, use_rdf)
    pos = _points().reshape(8, 8, 3)
    for jfield, tfield in (
        (jscene.soft_scene_field(js, TAU), tscene.soft_scene_field(ts, TAU)),
        (jscene.hard_scene_field(js), tscene.hard_scene_field(ts)),
    ):
        ju, jw = jfield(jnp.asarray(pos))
        tu, tw = tfield(torch.from_numpy(pos))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=2e-6, rtol=2e-7)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-6, rtol=2e-7)
    _, tw = tscene.hard_scene_field(ts)(torch.from_numpy(pos))
    assert tw[..., 1].sum() == 0 and tw[..., 3].sum() == 0
    np.testing.assert_allclose(
        tscene.batched_sdf(tscene.hard_scene_field(ts), torch.from_numpy(pos)).numpy(),
        np.asarray(jscene.batched_sdf(jscene.hard_scene_field(js), jnp.asarray(pos))),
        atol=2e-6, rtol=2e-7)


@pytest.mark.parametrize("use_rdf", [False, True])
def test_scene_fields_with_no_valid_instance(use_rdf):
    """The hard union gives finfo.max and a one-hot at 0 in both packages
    (not NaN). The soft union masks as the kernels do, so the port's
    weights are uniform where the JAX package's -inf mask gives NaN."""
    x = _scene_inputs(valid=(0, 0, 0, 0))
    js, ts = _scenes(x, use_rdf)
    pos = _points(16)
    ju, jw = jscene.hard_scene_field(js)(jnp.asarray(pos))
    tu, tw = tscene.hard_scene_field(ts)(torch.from_numpy(pos))
    big = np.finfo(np.float32).max
    np.testing.assert_array_equal(tu.numpy(), np.full(16, big, np.float32))
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    su, sw = tscene.soft_scene_field(ts, TAU)(torch.from_numpy(pos))
    assert torch.isfinite(su).all()
    np.testing.assert_allclose(sw.numpy(), 0.25, atol=1e-7)
    assert np.isnan(np.asarray(jscene.soft_scene_field(js, TAU)(jnp.asarray(pos))[1])).all()


def test_masked_hard_union_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(40, 5)).astype(np.float32)
    d[:10, 2] = d[:10, 0]                                   # ties: the lowest index wins
    valid = np.array([True, False, True, True, False])
    ju, jw = jsdf.masked_hard_union(jnp.asarray(d.T), jnp.asarray(valid))
    tu, tw = tsdf.masked_hard_union(torch.from_numpy(d), torch.from_numpy(valid))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)


def test_batched_scene_field_matches_per_frame():
    xs = [_scene_inputs(seed=s, valid=v) for s, v in ((0, (1, 1, 1, 0)), (5, (0, 0, 0, 0)))]
    scenes = [_scenes(x, True)[1] for x in xs]
    stacked = tscene.SceneParams(*(torch.stack(parts) for parts in zip(*scenes)))
    pos = np.stack([_points(32, seed=2), _points(32, seed=3)])
    for make in (lambda s: tscene.soft_scene_field(s, TAU), tscene.hard_scene_field):
        bu, bw = make(stacked)(torch.from_numpy(pos))
        for f in range(2):
            u, w = make(scenes[f])(torch.from_numpy(pos[f]))
            np.testing.assert_allclose(bu[f].numpy(), u.numpy(), atol=2e-6, rtol=0)
            np.testing.assert_allclose(bw[f].numpy(), w.numpy(), atol=2e-6, rtol=0)


def test_grid_sample_and_its_grid_gradient_match_jax():
    rng = np.random.default_rng(4)
    image = rng.random((2, 7, 9)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(5, 6, 2)).astype(np.float32)
    cot = rng.normal(size=(2, 5, 6)).astype(np.float32)
    for align in (False, True):
        def jloss(g):
            out = jgs.grid_sample(jnp.asarray(image), g, align_corners=align)
            return jnp.sum(out * cot), out
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(grid))
        tgrid = torch.from_numpy(grid).requires_grad_(True)
        tout = tgs.grid_sample(torch.from_numpy(image), tgrid, align_corners=align)
        (tgrad,) = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), tgrid)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=0)
    batch = np.stack([image, image[::-1]])
    grids = np.stack([grid, grid[::-1]])
    jb = jgs.grid_sample_nchw(jnp.asarray(batch), jnp.asarray(grids))
    tb = tgs.grid_sample_nchw(torch.from_numpy(batch), torch.from_numpy(grids))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)


def _rays(r=48, seed=6, origin=(0.0, 0.0, 0.0), spread=0.5):
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-spread, spread, r), rng.uniform(-spread, spread, r),
                  np.ones(r)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(origin), (r, 3))
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("case", ["init", "plain", "capped"])
def test_sphere_tracing_twin_matches_jax(use_rdf, case):
    """The march and the differentiable last step: with initialization
    (rays start on the bounding sphere), without it (rays start at the
    camera, some leave the sphere before the frame stops) and capped at
    num_iterations (some rays still marching)."""
    x = _scene_inputs(spread=2.0, depth=12.0)
    js, ts = _scenes(x, use_rdf)
    if case == "init":
        o, d = _rays(origin=(0.0, 0.0, -40.0), spread=0.08)
    else:
        o, d = _rays()
    iters = 6 if case == "capped" else 200
    radius = 30.0
    kw = dict(num_iterations=iters, convergence_criteria=0.01, bounding_radius=radius,
              initialization=case == "init", differentiable=True)
    jfield = jscene.hard_scene_field(js)
    jp, jc = jrenderer.sphere_tracing(lambda p: jscene.batched_sdf(jfield, p),
                                      jnp.asarray(o), jnp.asarray(d), **kw)
    tfield = tscene.hard_scene_field(ts)
    sdf_fn = lambda p: tscene.batched_sdf(tfield, p)  # noqa: E731
    tp, tc = trenderer.sphere_tracing(sdf_fn, torch.from_numpy(o), torch.from_numpy(d), **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-4, rtol=0)
    conv = tc[..., 0].numpy()
    out = np.linalg.norm(tp.detach().numpy(), axis=-1) >= radius
    if case == "capped":
        assert (~conv & ~out).any()          # rays still marching at the cap
    else:
        assert conv.any() and out.any()      # surfels, and rays that left the sphere
    # the same march through scene.march (the kernel's twin on CPU tensors)
    march = lambda p, v, fg: tscene.march(ts, p, v, fg, iters, 0.01, radius)  # noqa: E731
    mp, mc = trenderer.sphere_tracing(sdf_fn, torch.from_numpy(o), torch.from_numpy(d),
                                      march=march, **kw)
    np.testing.assert_array_equal(mc.numpy(), tc.numpy())
    np.testing.assert_array_equal(mp.detach().numpy(), tp.detach().numpy())


@pytest.mark.parametrize("epsilon", [None, 1e-3])
def test_surface_normal_matches_jax(epsilon):
    x = _scene_inputs()
    js, ts = _scenes(x, True)
    pos = _points(40, seed=8)
    jn = jrenderer.surface_normal(lambda p: jscene.batched_sdf(jscene.hard_scene_field(js), p),
                                  jnp.asarray(pos), epsilon)
    tn = trenderer.surface_normal(lambda p: tscene.batched_sdf(tscene.hard_scene_field(ts), p),
                                  torch.from_numpy(pos), epsilon)
    atol = 1e-5 if epsilon is None else 2e-3   # differences of f32 distances over 2e-3 m
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), atol=atol, rtol=0)


def test_phong_and_shadows_match_jax():
    rng = np.random.default_rng(9)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa
    rays, normals = unit(rng.normal(size=(30, 3))), unit(rng.normal(size=(30, 3)))
    light = unit(np.array([[0.3, -1.0, 0.2]]))
    colors = [np.float32(c) for c in (0.2, 0.7, 0.5, 0.1, 0.6, 0.3, 0.05)] + [np.float32(8.0)]
    jc = jrenderer.phong_shading(jnp.asarray(rays), jnp.asarray(normals), jnp.asarray(light),
                                 *colors)
    tc = trenderer.phong_shading(torch.from_numpy(rays), torch.from_numpy(normals),
                                 torch.from_numpy(light), *colors)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)

    x = _scene_inputs(spread=2.0, depth=12.0)
    js, ts = _scenes(x, False)
    o, d = _rays(origin=(0.0, 0.0, 0.0))
    kw = dict(num_iterations=100, convergence_criteria=0.01, bounding_radius=30.0,
              initialization=False)
    jp, jconv = jrenderer.sphere_tracing(
        lambda p: jscene.batched_sdf(jscene.hard_scene_field(js), p), jnp.asarray(o),
        jnp.asarray(d), **kw)
    light = np.broadcast_to(unit(np.array([[0.2, 1.0, 0.3]])), d.shape).copy()
    js_ = jrenderer.shadow_rendering(
        lambda p: jscene.batched_sdf(jscene.hard_scene_field(js), p), jp,
        jnp.asarray(-d), jnp.asarray(light), 100, 0.01, jconv, 30.0)
    ts_ = trenderer.shadow_rendering(
        lambda p: tscene.batched_sdf(tscene.hard_scene_field(ts), p), torch.from_numpy(
            np.asarray(jp)), torch.from_numpy(-d), torch.from_numpy(light), 100, 0.01,
        torch.from_numpy(np.asarray(jconv)), 30.0)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
