"""Ray-distance samplers: stratified quadrature and inverse-CDF importance.

Counterpart of ``vsrd_tpu/rendering/samplers.py``, with explicit
``torch.Generator``s and the same hardening of the inverse CDF (the
uniform draws are clipped into the realised CDF range and the bracket
fraction clamped to [0, 1]).
"""

from __future__ import annotations

import torch


def _uniform(shape, generator, like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) draws shaped ``shape``, on ``like``'s device and dtype."""
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def quadrature_sampler(bins: torch.Tensor, deterministic: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Stratified samples within consecutive bins: ``bins [..., S+1]`` ->
    ``[..., S]``, one uniform jitter per bin (midpoints if deterministic)."""
    lo = bins[..., :-1]
    hi = bins[..., 1:]
    if deterministic:
        w = 0.5
    else:
        w = _uniform(lo.shape, generator, bins)
    return lo + (hi - lo) * w


def inverse_transform_sampler(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Importance-sample ``num_samples`` distances per ray from the
    piecewise-constant PDF ``weights [..., S-1]`` over ``bins [..., S]``."""
    pdf = weights / torch.clamp(torch.sum(torch.abs(weights), dim=-1, keepdim=True), min=1e-12)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., S]

    shape = (*cdf.shape[:-1], num_samples)
    if deterministic:
        uniform = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device)
        uniform = uniform.expand(shape)
    else:
        uniform = _uniform(shape, generator, cdf)
        uniform = torch.sort(uniform, dim=-1).values
    # keep u inside the realised CDF range: cdf[-1] is 1 only up to
    # rounding, and a u above it would pair with a bracket that does not
    # contain it and extrapolate the last sample
    uniform = torch.minimum(uniform, cdf[..., -1:]).contiguous()

    # i = #{cdf < u}, the left-side searchsorted of the sorted CDF
    indices = torch.searchsorted(cdf.contiguous(), uniform, side="left")
    indices = torch.clamp(indices, 1, cdf.shape[-1] - 1)
    min_cdf = torch.gather(cdf, -1, indices - 1)
    max_cdf = torch.gather(cdf, -1, indices)
    min_bins = torch.gather(bins, -1, indices - 1)
    max_bins = torch.gather(bins, -1, indices)

    t = (uniform - min_cdf) / (max_cdf - min_cdf + 1e-6)
    # binds only on degenerate (near-zero-mass) brackets
    t = torch.clamp(t, 0.0, 1.0)
    return min_bins + (max_bins - min_bins) * t
