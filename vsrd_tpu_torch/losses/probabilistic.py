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


def reparameterized_gamma(shape_param: torch.Tensor, draw: torch.Tensor):
    """``draw``, Gamma(shape_param, 1) draws, with the implicit
    reparameterization gradient dG/da = -(dF/da)(G; a) / f(G; a), F the
    gamma CDF, as the JAX package's gamma sampler differentiates. The value
    is ``draw`` exactly; ``shape_param`` broadcasts to ``draw``'s shape."""
    a = torch.broadcast_to(shape_param, draw.shape)
    dg_da = torch._standard_gamma_grad(a.detach(), draw.detach())
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
