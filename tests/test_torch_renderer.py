"""The port's NeuS renderer and samplers against the JAX package's.

Tolerances: neus_weights 1e-6 absolute (the JAX package takes the
transmittance as exp of a log-prefix-sum, the port as a plain cumprod;
both f32); samplers 1e-5 absolute plus 1e-6 relative (a few f32 ulps of
distances up to 100 m);
hierarchical_render 1e-5 on distances and features, 1e-4 on gradients
(the field's spatial gradient, see test_torch_field_kernels).
"""

import jax.numpy as jnp
import numpy as np
import torch

from vsrd_tpu.models import hyper_field as jhf
from vsrd_tpu.rendering import renderer as jr, samplers as js, scene
from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import renderer as tr, samplers as ts

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def test_anneal_and_neus_weights_match():
    sdf = RNG.normal(size=(6, 9)).astype(np.float32) * 2
    cos = RNG.uniform(-1, 1, size=(6, 9)).astype(np.float32)
    intervals = RNG.uniform(0.1, 2.0, size=(6, 9)).astype(np.float32)
    for ratio in (0.0, 0.4, 1.0):
        np.testing.assert_allclose(
            np.asarray(jr.anneal_cosines(jnp.asarray(cos), ratio)),
            tr.anneal_cosines(torch.from_numpy(cos), ratio).numpy(), atol=1e-7)
        a = jr.neus_weights(jnp.asarray(sdf), jnp.asarray(cos), jnp.asarray(intervals), 0.7, ratio)
        b = tr.neus_weights(torch.from_numpy(sdf), torch.from_numpy(cos),
                            torch.from_numpy(intervals), 0.7, ratio)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


def test_samplers_match_in_deterministic_mode():
    bins = np.sort(RNG.uniform(0, 100, size=(5, 9)).astype(np.float32), axis=-1)
    np.testing.assert_allclose(
        np.asarray(js.quadrature_sampler(None, jnp.asarray(bins), True)),
        ts.quadrature_sampler(torch.from_numpy(bins), True).numpy(), atol=1e-5)
    weights = RNG.uniform(0, 1, size=(5, 8)).astype(np.float32)
    weights[1] = 0.0                     # a ray with no mass
    weights[2, 3:] = 0.0                 # trailing empty bins
    a = js.inverse_transform_sampler(None, jnp.asarray(bins), jnp.asarray(weights), 7, True)
    b = ts.inverse_transform_sampler(torch.from_numpy(bins), torch.from_numpy(weights), 7, True)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5, rtol=1e-6)


def test_samplers_stay_in_range_with_a_generator():
    bins = torch.linspace(0, 10, 9).expand(4, 9)
    gen = torch.Generator().manual_seed(0)
    q = ts.quadrature_sampler(bins, False, gen)
    assert torch.all((q >= bins[..., :-1]) & (q <= bins[..., 1:]))
    f = ts.inverse_transform_sampler(q, torch.rand(4, 7, generator=gen), 16, False, gen)
    assert torch.all((f >= q[..., :1]) & (f <= q[..., -1:]))


def test_hierarchical_render_with_a_fixed_field():
    n, r, s = 4, 12, 8
    loc = (RNG.normal(size=(n, 3)) * 2 + [0, 0, 12]).astype(np.float32)
    ang = RNG.uniform(-1, 1, n)
    rot = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]], np.float32) for a in ang])
    half = RNG.uniform(0.5, 2, (n, 3)).astype(np.float32)
    valid = np.array([1, 1, 1, 0], bool)
    w = (RNG.normal(size=(n, 1617)) * 0.3).astype(np.float32)
    origins = np.zeros((r, 3), np.float32)
    dirs = (RNG.normal(size=(r, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tau, std, ratio = 0.7, 0.6, 0.3

    packed = tuple(jhf.pack_block_diagonal(jnp.asarray(w)))
    sp = scene.SceneParams(jnp.asarray(loc), jnp.asarray(rot), jnp.asarray(half),
                           jnp.asarray(valid), packed_weights=packed)
    ref = jr.hierarchical_render(scene.soft_scene_field(sp, tau), jnp.asarray(origins),
                                 jnp.asarray(dirs), (0.0, 100.0), s, std, ratio,
                                 deterministic=True)

    t = torch.from_numpy

    def field_with_grad(positions):
        shape = positions.shape[:-1]
        u, wts, g = fk.fused_field_with_grad(
            positions.reshape(-1, 3), t(loc), t(rot), t(half), t(valid.astype(np.float32)),
            t(w), torch.tensor(tau))
        return u.reshape(shape), wts.reshape(*shape, n), g.reshape(*shape, 3)

    out = tr.hierarchical_render(t(origins), t(dirs), (0.0, 100.0), s, torch.tensor(std),
                                 torch.tensor(ratio), field_with_grad=field_with_grad,
                                 deterministic=True)
    np.testing.assert_allclose(out.distances.numpy(), np.asarray(ref.distances), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(out.weights.detach().numpy(), np.asarray(ref.weights), atol=1e-5)
    np.testing.assert_allclose(out.features.detach().numpy(), np.asarray(ref.features),
                               atol=1e-5)
    np.testing.assert_allclose(out.gradients.detach().numpy(), np.asarray(ref.gradients),
                               atol=1e-4)
