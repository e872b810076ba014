"""Volumetric NeuS renderer with hierarchical (coarse + fine) sampling.

Counterpart of ``anneal_cosines``, ``neus_weights``, ``render_rays`` and
``hierarchical_render`` in ``vsrd_tpu/rendering/renderer.py``. The field
comes in as evaluators backed by the field kernels:

* ``field_with_grad(positions [R, S, 3]) -> (sdf, features, gradients)``;
* ``field_with_dir_grad(positions, directions) -> (sdf, features,
  u_dot)``, the derivative along the ray, for the gradient-stopped coarse
  pass, whose only use of the gradient is the NeuS section cosine.

Transmittance is a plain exclusive ``torch.cumprod`` (the JAX package's
log-matmul cumprod is a TPU workaround).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import samplers


class RenderOutputs(NamedTuple):
    features: torch.Tensor    # [R, F] accumulated per-ray features
    gradients: torch.Tensor   # [R, S, 3] SDF gradients at sample points
    distances: torch.Tensor   # [R, S+1] sampled distances (bin edges)
    weights: torch.Tensor     # [R, S] compositing weights


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod over the last axis shifted by one, with a leading 1."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def anneal_cosines(cosines: torch.Tensor, cosine_ratio) -> torch.Tensor:
    """NeuS cos-anneal."""
    eased = F.relu(-cosines * 0.5 + 0.5)
    hard = F.relu(-cosines)
    return -(eased + (hard - eased) * cosine_ratio)


def neus_weights(sdf, cosines, intervals, sdf_std_deviation, cosine_ratio,
                 epsilon: float = 1e-6):
    """Section opacities and compositing weights along the sample axis."""
    cosines = anneal_cosines(cosines, cosine_ratio)
    prev_sdf = sdf - cosines * intervals / 2.0
    next_sdf = sdf + cosines * intervals / 2.0
    prev_cdf = torch.sigmoid(prev_sdf / sdf_std_deviation)
    next_cdf = torch.sigmoid(next_sdf / sdf_std_deviation)
    opacities = F.relu((prev_cdf - next_cdf) / (prev_cdf + epsilon))
    return exclusive_cumprod(1.0 - opacities) * opacities


def render_rays(
    ray_positions: torch.Tensor,
    ray_directions: torch.Tensor,
    distance_range,
    num_samples: int,
    sdf_std_deviation,
    cosine_ratio=1.0,
    *,
    field_with_grad=None,
    field_with_dir_grad=None,
    sampled_distances: torch.Tensor | None = None,
    sampled_weights: torch.Tensor | None = None,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
    epsilon: float = 1e-6,
) -> RenderOutputs:
    """One volumetric pass over ``[R]`` rays: stratified samples over
    ``distance_range`` (coarse), or importance samples against
    ``sampled_weights`` merged and sorted with ``sampled_distances``
    (fine). With ``field_with_dir_grad`` the clipped derivative along the
    ray stands in for the section cosine and the gradients are zeros."""
    if sampled_distances is None:
        lo, hi = distance_range
        bins = torch.linspace(lo, hi, num_samples + 1, dtype=ray_directions.dtype,
                              device=ray_directions.device)
        bins = bins.expand(*ray_directions.shape[:-1], num_samples + 1)
        distances = samplers.quadrature_sampler(bins, deterministic, generator)
    else:
        fine = samplers.inverse_transform_sampler(
            sampled_distances, sampled_weights, num_samples, deterministic, generator
        )
        distances = torch.sort(torch.cat([sampled_distances, fine], dim=-1), dim=-1).values

    intervals = distances[..., 1:] - distances[..., :-1]
    midpoints = (distances[..., :-1] + distances[..., 1:]) / 2.0
    positions = ray_positions[..., None, :] + ray_directions[..., None, :] * midpoints[..., None]

    if field_with_dir_grad is not None:
        dirs = ray_directions[..., None, :].expand(positions.shape)
        sdf, features, u_dot = field_with_dir_grad(positions, dirs)
        # |grad| ~ 1 for an SDF; the clip keeps the section estimate sane
        # where the softmin union or the residual dents the norm
        cosines = torch.clamp(u_dot, -1.0, 1.0)
        gradients = torch.zeros_like(positions)
    else:
        sdf, features, gradients = field_with_grad(positions)
        norms = torch.linalg.vector_norm(gradients, dim=-1)
        normals = gradients / torch.clamp(norms, min=1e-12)[..., None]
        cosines = torch.sum(ray_directions[..., None, :] * normals, dim=-1)

    weights = neus_weights(sdf, cosines, intervals, sdf_std_deviation, cosine_ratio, epsilon)
    accumulated = torch.sum(features * weights[..., None], dim=-2)
    return RenderOutputs(accumulated, gradients, distances, weights)


def hierarchical_render(
    ray_positions: torch.Tensor,
    ray_directions: torch.Tensor,
    distance_range,
    num_samples: int,
    sdf_std_deviation,
    cosine_ratio=1.0,
    *,
    field_with_grad,
    field_with_dirgrad_coarse=None,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
) -> RenderOutputs:
    """Coarse pass under ``torch.no_grad`` (with ``field_with_dirgrad_coarse``
    if given, else ``field_with_grad``), then the differentiable fine pass
    at the merged coarse + importance samples."""
    with torch.no_grad():
        coarse = render_rays(
            ray_positions, ray_directions, distance_range, num_samples,
            sdf_std_deviation, cosine_ratio,
            field_with_grad=field_with_grad,
            field_with_dir_grad=field_with_dirgrad_coarse,
            deterministic=deterministic, generator=generator,
        )
    return render_rays(
        ray_positions, ray_directions, distance_range, num_samples,
        sdf_std_deviation, cosine_ratio,
        field_with_grad=field_with_grad,
        sampled_distances=coarse.distances.detach(),
        sampled_weights=coarse.weights.detach(),
        deterministic=deterministic, generator=generator,
    )
