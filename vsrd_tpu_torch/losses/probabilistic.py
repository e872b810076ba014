"""Probabilistic regression losses: negative log-likelihoods and energy
scores.

Counterpart of ``vsrd_tpu/losses/probabilistic.py``: explicit log-density
formulas and explicit random streams for the Monte-Carlo energy scores.
torch's gamma and Student-t samplers take no ``torch.Generator``, so the
default draws are built here from generator-driven normals and uniforms:
a gamma by Marsaglia and Tsang's method, a Student-t as a normal over the
square root of a chi-square / dof built from that gamma. They follow the
distributions, not the JAX package's bits; ``samples`` injects a draw.
As in the JAX package, the gamma draw passes a gradient to its shape by
implicit reparameterization, so the Student-t energy score differentiates
in the shapes as well as in the means and scales.
"""

from __future__ import annotations

import math

import torch

from .utils import reduced


def _normal_log_prob(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


def _student_t_log_prob(x, df, loc, scale):
    z = (x - loc) / scale
    return (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi) - torch.log(scale)
            - (df + 1.0) / 2.0 * torch.log1p(z * z / df))


def standard_gamma(shape_param: torch.Tensor, generator: torch.Generator | None = None):
    """Gamma(shape_param, 1) draws of ``shape_param``'s shape by Marsaglia and
    Tsang's rejection method, every draw from ``generator``; a shape below 1
    draws at shape + 1 and multiplies by U^(1 / shape)."""
    like = dict(dtype=shape_param.dtype, device=shape_param.device)
    boosted = shape_param < 1.0
    a = torch.where(boosted, shape_param + 1.0, shape_param)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    pending = torch.ones_like(a, dtype=torch.bool)
    while bool(pending.any()):
        x = torch.randn(a.shape, generator=generator, **like)
        u = torch.rand(a.shape, generator=generator, **like)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    u = torch.rand(a.shape, generator=generator, **like)
    return torch.where(boosted, out * u ** (1.0 / shape_param), out)


def _igamma_series_sample_derivative(x, a, enabled):
    """XLA's ``_igamma_series`` in its sample-derivative mode: the series of
    P(a, x) and its derivative in ``a``, each entry iterating until its
    derivative term falls below the dtype's epsilon."""
    eps = torch.finfo(x.dtype).eps
    r, c, ans = a, torch.ones_like(a), torch.ones_like(a)
    dc_da, dans_da = torch.zeros_like(a), torch.zeros_like(a)
    while bool(enabled.any()):
        r_new = r + 1.0
        dc_da_new = dc_da * (x / r_new) - (c * x) / (r_new * r_new)
        dans_da_new = dans_da + dc_da_new
        c_new = c * (x / r_new)
        ans_new = ans + c_new
        r = torch.where(enabled, r_new, r)
        c = torch.where(enabled, c_new, c)
        ans = torch.where(enabled, ans_new, ans)
        dc_da = torch.where(enabled, dc_da_new, dc_da)
        dans_da = torch.where(enabled, dans_da_new, dans_da)
        enabled = enabled & (torch.abs(dc_da_new / dans_da_new) > eps)
    dlogax_da = torch.log(x) - torch.digamma(a + 1.0)
    return -(dans_da + ans * dlogax_da) * x / a


def _igammac_continued_fraction_sample_derivative(x, a, enabled):
    """XLA's ``_igammac_continued_fraction`` in its sample-derivative mode:
    the continued fraction of Q(a, x) and its derivative in ``a``, at most
    2000 terms, with XLA's rescaling of the convergents by epsilon."""
    eps = torch.finfo(x.dtype).eps
    y = 1.0 - a
    z = x + y + 1.0
    pkm2, qkm2 = torch.ones_like(x), x
    pkm1, qkm1 = x + 1.0, z * x
    ans = pkm1 / qkm1
    dpkm2_da, dqkm2_da = torch.zeros_like(x), torch.zeros_like(x)
    dpkm1_da, dqkm1_da = torch.zeros_like(x), -x
    dans_da = (dpkm1_da - ans * dqkm1_da) / qkm1
    c = 0.0
    while c < 2000 and bool(enabled.any()):
        c += 1.0
        y_new = y + 1.0
        z_new = z + 2.0
        yc = y_new * c
        pk = pkm1 * z_new - pkm2 * yc
        qk = qkm1 * z_new - qkm2 * yc
        nonzero = qk != 0
        ans_new = torch.where(nonzero, pk / qk, ans)
        dpk_da = dpkm1_da * z_new - pkm1 - dpkm2_da * yc + pkm2 * c
        dqk_da = dqkm1_da * z_new - qkm1 - dqkm2_da * yc + qkm2 * c
        dans_da_new = torch.where(nonzero, (dpk_da - ans_new * dqk_da) / qk, dans_da)
        grad_conditional = torch.where(nonzero, torch.abs(dans_da_new - dans_da),
                                       torch.ones_like(dans_da))
        rescale = torch.abs(pk) > 1.0 / eps
        scale = torch.where(rescale, torch.full_like(pk, eps), torch.ones_like(pk))
        new = (pkm1 * scale, qkm1 * scale, pk * scale, qk * scale,
               dpkm1_da * scale, dqkm1_da * scale, dpk_da * scale, dqk_da * scale)
        old = (pkm2, qkm2, pkm1, qkm1, dpkm2_da, dqkm2_da, dpkm1_da, dqkm1_da)
        (pkm2, qkm2, pkm1, qkm1, dpkm2_da, dqkm2_da, dpkm1_da, dqkm1_da) = (
            torch.where(enabled, n, o) for n, o in zip(new, old))
        ans = torch.where(enabled, ans_new, ans)
        y = torch.where(enabled, y_new, y)
        z = torch.where(enabled, z_new, z)
        dans_da = torch.where(enabled, dans_da_new, dans_da)
        enabled = enabled & (grad_conditional > eps)
    dlogax_da = torch.log(x) - torch.digamma(a)
    return -(dans_da + ans * dlogax_da) * x


def random_gamma_grad(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dG/da of Gamma(a, 1) draws ``x``, -(dF/da)(x; a) / f(x; a) with F the
    gamma CDF: XLA's ``random_gamma_grad`` (``jax.lax.random_gamma_grad``)
    written out, in ``x``'s dtype. The series of P(a, x) serves x <= 1 or
    x <= a, the continued fraction of Q(a, x) the rest; 0 at x = 0, NaN
    outside the domain."""
    a = a.to(x.dtype)
    is_nan = torch.isnan(a) | torch.isnan(x)
    x_is_zero = x == 0
    domain_error = (x < 0) | (a <= 0)
    use_igammac = (x > 1) & (x > a)
    underflow = a * torch.log(x) - x - torch.lgamma(a) < -math.log(torch.finfo(x.dtype).max)
    enabled = ~(x_is_zero | domain_error | underflow | is_nan)
    output = torch.where(
        use_igammac,
        -_igammac_continued_fraction_sample_derivative(x, a, enabled & use_igammac),
        _igamma_series_sample_derivative(x, a, enabled & ~use_igammac))
    output = torch.where(x_is_zero, torch.zeros_like(output), output)
    return torch.where(domain_error | is_nan, torch.full_like(output, math.nan), output)


def reparameterized_gamma(shape_param: torch.Tensor, draw: torch.Tensor):
    """``draw``, Gamma(shape_param, 1) draws, with the implicit
    reparameterization gradient dG/da = -(dF/da)(G; a) / f(G; a), F the
    gamma CDF, from ``random_gamma_grad`` as the JAX package's gamma sampler
    differentiates. The value is ``draw`` exactly; ``shape_param``
    broadcasts to ``draw``'s shape."""
    a = torch.broadcast_to(shape_param, draw.shape)
    dg_da = random_gamma_grad(a.detach(), draw.detach())
    return draw.detach() + (a - a.detach()) * dg_da


def standard_t(df: torch.Tensor, generator: torch.Generator | None = None):
    """Student-t draws with ``df`` degrees of freedom, of ``df``'s shape:
    Z sqrt((df / 2) / G), G ~ Gamma(df / 2, 1), differentiable in ``df``."""
    z = torch.randn(df.shape, generator=generator, dtype=df.dtype, device=df.device)
    half = df / 2.0
    return z * torch.sqrt(half / reparameterized_gamma(half, standard_gamma(half.detach(),
                                                                             generator)))


def _energy(samples, targets):
    inter = torch.mean(torch.abs(samples - targets[None, ...]), dim=0)
    intra = torch.mean(torch.abs(samples[:-1] - samples[1:]), dim=0)
    return inter - intra * 0.5


@reduced
def gaussian_nll(means, variances, targets, epsilon=1e-6):
    return -_normal_log_prob(targets, means, torch.sqrt(variances + epsilon))


@reduced
def student_nll(means, shapes, scales, targets, epsilon=1e-6):
    """NLL of the Student-t of a Gaussian with Inverse-Gamma variance:
    dof = 2 shape, scale^2 = scale / shape."""
    return -_student_t_log_prob(targets, 2.0 * shapes, means,
                                torch.sqrt(scales / shapes + epsilon))


@reduced
def gaussian_energy_score(generator, means, variances, targets, num_samples=1000,
                          epsilon=1e-6, samples=None):
    """Monte-Carlo energy score of N(means, variances). ``samples
    [num_samples, *means.shape]``, standard normals, replaces the draw
    from ``generator``."""
    if samples is None:
        samples = torch.randn((num_samples, *means.shape), generator=generator,
                              dtype=means.dtype, device=means.device)
    return _energy(means + torch.sqrt(variances + epsilon) * samples, targets)


@reduced
def student_energy_score(generator, means, shapes, scales, targets, num_samples=1000,
                         epsilon=1e-6, samples=None):
    """Monte-Carlo energy score of the Student-t of ``student_nll``.
    ``samples``, a pair ``(normals, gammas)`` of ``[num_samples,
    *means.shape]`` standard normals and Gamma(shapes, 1) draws, replaces
    the draw from ``generator``; the t draw is normals sqrt(shapes /
    gammas), as ``jax.random.t`` builds it at 2 shapes degrees of freedom,
    and the shapes' gradient runs through the gammas either way."""
    size = (num_samples, *means.shape)
    if samples is None:
        draws = standard_t(torch.broadcast_to(2.0 * shapes, size), generator)
    else:
        normals, gammas = samples
        draws = normals * torch.sqrt(shapes / reparameterized_gamma(shapes, gammas))
    return _energy(means + torch.sqrt(scales / shapes + epsilon) * draws, targets)


@reduced
def logit_gaussian_nll(means, variances, targets, epsilon=1e-6):
    """NLL of sigmoid(Normal) at targets in (0, 1)."""
    targets = torch.clamp(targets, epsilon, 1.0 - epsilon)
    logits = torch.log(targets) - torch.log1p(-targets)
    base = _normal_log_prob(logits, means, torch.sqrt(variances + epsilon))
    log_det = -torch.log(targets) - torch.log1p(-targets)   # d logit / dx = 1 / (x (1 - x))
    return -(base + log_det)


@reduced
def logit_student_nll(means, shapes, scales, targets, epsilon=1e-6):
    targets = torch.clamp(targets, epsilon, 1.0 - epsilon)
    logits = torch.log(targets) - torch.log1p(-targets)
    base = _student_t_log_prob(logits, 2.0 * shapes, means,
                               torch.sqrt(scales / shapes + epsilon))
    log_det = -torch.log(targets) - torch.log1p(-targets)
    return -(base + log_det)
