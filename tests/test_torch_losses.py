"""The port's library losses (``vsrd_tpu_torch/losses/``) against the JAX
package's: every loss, with every ``reduction``, and its gradient.

Inputs come from a numpy seed and go through both packages in float32.
The energy scores run with JAX's draws injected (``samples``), so they
compare exactly; their default draws (from a ``torch.Generator``) are held
to the JAX package's statistics at a Monte-Carlo tolerance.

Tolerances, with their reasons: values and gradients 1e-5 relative to the
reference's scale (max(max|ref|, 1e-3)); the Student-t log-densities 2e-5
(``lgamma`` in two libraries); the default-draw energy scores 3 % of the
score at 40,000 samples (the Monte-Carlo error of two independent runs is
about 0.5 % there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu import losses as jlosses
from vsrd_tpu_torch import losses as tlosses
from vsrd_tpu_torch.losses import probabilistic as tprob

torch.set_num_threads(2)
REDUCTIONS = ("none", "mean", "sum")


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-3)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= rtol, err


def _probs(rng, shape):
    return rng.uniform(0.02, 0.98, size=shape).astype(np.float32)


def _extrinsics(rng, b):
    from vsrd_tpu.ops import geometry as jgeo
    axes = rng.normal(size=(b, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    rot = np.asarray(jgeo.rotation_matrix(jnp.asarray(axes, jnp.float32),
                                          jnp.asarray(rng.normal(size=b) * 0.3, jnp.float32)))
    e = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    e[:, :3, :3] = rot
    e[:, :3, 3] = rng.normal(size=(b, 3))
    return e


def _cases():
    rng = np.random.default_rng(0)
    p = lambda *s: _probs(rng, s)  # noqa: E731
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    pos = lambda *s: rng.uniform(0.5, 2.0, size=s).astype(np.float32)  # noqa: E731
    f = np.asarray([[[400.0, 0, 60], [0, 400, 40], [0, 0, 1]]], np.float32)
    return {
        "cross_entropy": ((p(3, 5), p(3, 5)), dict(axis=-1)),
        "binary_cross_entropy": ((p(4, 6), p(4, 6)), {}),
        "kl_divergence": ((p(3, 5), p(3, 5)), dict(axis=-1, keepdims=True)),
        "binary_kl_divergence": ((p(4, 6), p(4, 6)), {}),
        "js_divergence": ((p(3, 5), p(3, 5)), dict(axis=-1)),
        "binary_js_divergence": ((p(4, 6), p(4, 6)), {}),
        "focal_loss": ((p(4, 6), p(4, 6)), {}),
        "quality_focal_loss": ((p(4, 6), p(4, 6)), {}),
        "tversky_loss": ((p(2, 3, 5, 6), p(2, 3, 5, 6)), {}),
        "focal_tversky_loss": ((p(2, 3, 5, 6), p(2, 3, 5, 6)), dict(alpha=0.6, beta=0.4)),
        "rotation_consistency_loss": ((_extrinsics(rng, 4), _extrinsics(rng, 4)), {}),
        "translation_consistency_loss": ((_extrinsics(rng, 4), _extrinsics(rng, 4)), {}),
        "sampson_epipolar_distance": ((n(2, 7, 2) * 50, n(2, 7, 2) * 50,
                                       np.linalg.inv(f).transpose(0, 2, 1).repeat(2, 0)
                                       @ n(2, 3, 3) @ np.linalg.inv(f)), {}),
        "gaussian_nll": ((n(3, 4), pos(3, 4), n(3, 4)), {}),
        "student_nll": ((n(3, 4), pos(3, 4) + 1.0, pos(3, 4), n(3, 4)), {}),
        "logit_gaussian_nll": ((n(3, 4), pos(3, 4), p(3, 4)), {}),
        "logit_student_nll": ((n(3, 4), pos(3, 4) + 1.0, pos(3, 4), p(3, 4)), {}),
        "smoothness_loss": ((pos(2, 1, 6, 7), n(2, 3, 6, 7)), {}),
        "motion_smoothness_loss": ((n(2, 2, 6, 7),), {}),
        "motion_sparsity_loss": ((n(2, 2, 6, 7),), {}),
    }


CASES = _cases()
STUDENT = ("student_nll", "logit_student_nll")


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name, reduction):
    args, kwargs = CASES[name]
    args = tuple(np.asarray(a, np.float32) for a in args)
    rtol = 2e-5 if name in STUDENT else 1e-5
    cot = np.random.default_rng(1).normal(size=np.shape(
        getattr(jlosses, name)(*args, **kwargs, reduction=reduction))).astype(np.float32)

    def jloss(*xs):
        out = getattr(jlosses, name)(*xs, **kwargs, reduction=reduction)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(args))),
                                           has_aux=True)(*map(jnp.asarray, args))
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    got = getattr(tlosses, name)(*xs, **kwargs, reduction=reduction)
    _close(got, want, rtol)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)), xs)
    for g, w in zip(grads, jgrads):
        _close(g, w, rtol)


def test_unknown_reduction_is_refused():
    with pytest.raises(ValueError):
        tlosses.binary_cross_entropy(torch.rand(3), torch.rand(3), reduction="max")


def _score_inputs(seed=2, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.uniform(1.5, 3.0, size=shape).astype(np.float32),
            rng.uniform(0.5, 2.0, size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_energy_scores_with_jax_samples_injected(kind, reduction):
    means, shapes, scales, targets = _score_inputs()
    key = jax.random.PRNGKey(5)
    num = 64
    if kind == "gaussian":
        draws = jax.random.normal(key, (num, *means.shape))
        args = (means, scales, targets)
        jfn, tfn = jlosses.gaussian_energy_score, tlosses.gaussian_energy_score
    else:
        # jax.random.t's own draw: a normal and a gamma at half the degrees
        key_n, key_g = jax.random.split(key)
        draws = (jax.random.normal(key_n, (num, *means.shape)),
                 jax.random.gamma(key_g, jnp.asarray(shapes), (num, *means.shape)))
        args = (means, shapes, scales, targets)
        jfn, tfn = jlosses.student_energy_score, tlosses.student_energy_score

    def jloss(*xs):
        out = jfn(key, *xs, num_samples=num, reduction=reduction)
        return jnp.sum(out), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, args))
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    injected = (torch.from_numpy(np.array(draws)) if kind == "gaussian"
                else tuple(torch.from_numpy(np.array(d)) for d in draws))
    got = tfn(None, *xs, num_samples=num, reduction=reduction, samples=injected)
    _close(got, want)
    # the Student-t draw depends on the shapes through its gamma draw, and
    # both differentiate through it by implicit reparameterization
    grads = torch.autograd.grad(torch.sum(got), xs[:3])
    for g, i in zip(grads, range(3)):
        _close(g, jgrads[i], rtol=1e-5)


def test_reparameterized_gamma_gradient_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0.3, 4.0, size=256).astype(np.float32)
    draws = np.array(jax.random.gamma(jax.random.PRNGKey(7), jnp.asarray(a)))
    want = jax.lax.random_gamma_grad(jnp.asarray(a), jnp.asarray(draws))
    at = torch.tensor(a, requires_grad=True)
    got = tprob.reparameterized_gamma(at, torch.from_numpy(draws))
    assert torch.equal(got.detach(), torch.from_numpy(draws))
    (grad,) = torch.autograd.grad(torch.sum(got), [at])
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-5)


def test_random_gamma_grad_matches_xla_over_2000_draws():
    """dG/da written out from XLA's series and continued fraction against
    jax.lax.random_gamma_grad in float32, 2,000 draws at a in [0.3, 4] that
    take both branches, and the edge values: 0 at x = 0, NaN outside the
    domain."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0.3, 4.0, size=2000).astype(np.float32)
    draws = np.array(jax.random.gamma(jax.random.PRNGKey(12), jnp.asarray(a)))
    assert (draws > 1).any() and (draws <= 1).any()
    want = np.asarray(jax.lax.random_gamma_grad(jnp.asarray(a), jnp.asarray(draws)))
    got = tprob.random_gamma_grad(torch.from_numpy(a), torch.from_numpy(draws))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    edge_a = np.array([1.5, 1.5, -1.0, 0.0], np.float32)
    edge_x = np.array([0.0, -1.0, 1.0, 1.0], np.float32)
    edge = tprob.random_gamma_grad(torch.from_numpy(edge_a), torch.from_numpy(edge_x)).numpy()
    np.testing.assert_array_equal(
        edge, np.asarray(jax.lax.random_gamma_grad(jnp.asarray(edge_a), jnp.asarray(edge_x))))


@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_energy_scores_default_draw_follow_jax_statistics(kind):
    means, shapes, scales, targets = _score_inputs(3, (4,))
    num = 40_000
    gen = torch.Generator().manual_seed(0)
    if kind == "gaussian":
        want = jlosses.gaussian_energy_score(jax.random.PRNGKey(0), means, scales, targets,
                                             num_samples=num, reduction="none")
        got = tlosses.gaussian_energy_score(gen, torch.from_numpy(means),
                                            torch.from_numpy(scales), torch.from_numpy(targets),
                                            num_samples=num, reduction="none")
    else:
        want = jlosses.student_energy_score(jax.random.PRNGKey(0), means, shapes, scales,
                                            targets, num_samples=num, reduction="none")
        got = tlosses.student_energy_score(gen, *map(torch.from_numpy,
                                                     (means, shapes, scales, targets)),
                                           num_samples=num, reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.03, atol=0.01)


@pytest.mark.parametrize("shape_param", [0.4, 1.0, 3.5])
def test_standard_gamma_moments(shape_param):
    """Gamma(a, 1) has mean a and variance a: at 200,000 draws both within
    3 % (about 6 standard errors of the mean at a = 0.4)."""
    draws = tprob.standard_gamma(torch.full((200_000,), shape_param, dtype=torch.float64),
                                 torch.Generator().manual_seed(1))
    assert abs(float(draws.mean()) / shape_param - 1) < 0.03
    assert abs(float(draws.var()) / shape_param - 1) < 0.03
    t = tprob.standard_t(torch.full((200_000,), 6.0, dtype=torch.float64),
                         torch.Generator().manual_seed(2))
    assert abs(float(t.var()) - 1.5) < 0.05            # df / (df - 2)
