"""Volumetric NeuS renderer with hierarchical (coarse + fine) sampling.

Counterpart of ``eval_field_with_grad``, ``anneal_cosines``,
``neus_weights``, ``render_rays`` and ``hierarchical_render`` in
``vsrd_tpu/rendering/renderer.py``. The field
comes in as evaluators backed by the field kernels:

* ``field_with_grad(positions [R, S, 3]) -> (sdf, features, gradients)``;
* ``field_with_dir_grad(positions, directions) -> (sdf, features,
  u_dot)``, the derivative along the ray, for the gradient-stopped coarse
  pass, whose only use of the gradient is the NeuS section cosine.

Transmittance is a plain exclusive ``torch.cumprod`` (the JAX package's
log-matmul cumprod is a TPU workaround).

The surface functions (``sphere_intersection``, ``sphere_tracing``,
``surface_gradient``, ``surface_normal``, ``phong_shading``,
``shadow_rendering``) are the counterparts of the JAX module's. The march of
``sphere_tracing`` is gradient-stopped: ``march_loop`` is its eager form, a
transcription of the JAX ``while_loop`` with one host read of its exit test
per trip, and the plain twin of the sphere-trace kernel, which
``scene.march`` launches for scene fields on the card. The differentiable
last step and the normals take the field's spatial gradient by
``torch.autograd.grad(create_graph=True)``, so that their own gradient
reaches the field's parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import samplers


class RenderOutputs(NamedTuple):
    features: torch.Tensor    # [R, F] accumulated per-ray features
    gradients: torch.Tensor   # [R, S, 3] SDF gradients at sample points
    distances: torch.Tensor   # [R, S+1] sampled distances (bin edges)
    weights: torch.Tensor     # [R, S] compositing weights


def eval_field_with_grad(field: Callable, positions: torch.Tensor):
    """``(sdf, features, d sdf / d position)`` of ``field(positions [...,
    3]) -> (sdf, features)``. The positions are constants; the spatial
    gradient comes from ``torch.autograd.grad(create_graph=True)`` while
    gradients are enabled, so all three outputs keep their graph to the
    field's parameters."""
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        sdf, features = field(pos)
        (grads,) = torch.autograd.grad(sdf.sum(), pos, create_graph=keep_graph)
    if not keep_graph:
        sdf, features = sdf.detach(), features.detach()
    return sdf, features, grads


class _ExclusiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` shifted by one, with a backward that reads nothing
    back. PyTorch's own cumprod backward asks the host whether the input
    holds a zero; this one handles both cases on the device. With y the
    inclusive cumprod of the input with its zeros set to 1, and c the
    inclusive count of zeros, the cotangent of x_k from the shifted
    cotangent g' is, summing over j >= k,

    * x_k != 0: sum of g'_j y_j where c_j = 0, over x_k;
    * x_k == 0: sum of g'_j y_j where c_j = 1 (0 unless x_k is its row's
      first zero).

    Without zeros that is PyTorch's ``reversed_cumsum(g' * cumprod(x)) /
    x`` operation for operation."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        cp = torch.cumprod(x, dim=-1)
        return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        shifted = torch.cat([grad[..., 1:], torch.zeros_like(grad[..., :1])], dim=-1)
        zero = x == 0
        safe = torch.where(zero, torch.ones_like(x), x)
        terms = shifted * torch.cumprod(safe, dim=-1)
        count = torch.cumsum(zero, dim=-1)

        def reversed_cumsum(t):
            return torch.flip(torch.cumsum(torch.flip(t, (-1,)), dim=-1), (-1,))

        before = reversed_cumsum(torch.where(count == 0, terms, 0.0))
        at_zero = reversed_cumsum(torch.where(count == 1, terms, 0.0))
        return torch.where(zero, at_zero, before / safe)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod over the last axis shifted by one, with a leading 1; its
    backward is exact at zeros and never waits on the device."""
    return _ExclusiveCumprod.apply(x)


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


def sphere_intersection(ray_positions, ray_directions, bounding_radius):
    """Ray/sphere intersection about the origin: ``(near [..., 1], far [...,
    1], hit [..., 1])``."""
    a = torch.sum(ray_directions * ray_directions, dim=-1, keepdim=True)
    b = torch.sum(ray_directions * ray_positions, dim=-1, keepdim=True)
    c = torch.sum(ray_positions * ray_positions, dim=-1, keepdim=True) - bounding_radius**2.0
    d = b * b - a * c
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    return (-b - sqrt_d) / a, (-b + sqrt_d) / a, d >= 0.0


def march_loop(sdf_fn: Callable[[torch.Tensor], torch.Tensor], positions, directions,
               foreground_masks, num_iterations: int, convergence_criteria: float,
               bounding_radius: float | None = None):
    """The gradient-stopped march of one frame's rays, as the JAX package's
    ``while_loop`` runs it; the plain twin of the sphere-trace kernel.

    A trip evaluates ``sd`` at the current positions, moves the rays that
    were in the foreground and not converged before the trip by ``sd`` along
    their direction, drops the rays that left the bounding sphere from the
    foreground, and only then sets ``converged = |sd| < criterion``. The
    frame runs while any ray is in the foreground and not converged, up to
    ``num_iterations`` trips. ``foreground_masks [..., 1]`` bool. Returns
    ``(positions, converged [..., 1], trips, sd [..., 1])``, ``sd`` the
    distances of the last trip, which decided ``converged`` (``None`` when
    no trip ran)."""
    with torch.no_grad():
        positions = positions.detach()
        directions = directions.detach()
        fg = foreground_masks
        conv = torch.zeros_like(fg)
        trips, sd = 0, None
        while trips < num_iterations and bool(torch.any(fg & ~conv)):
            sd = sdf_fn(positions)
            positions = torch.where(fg & ~conv, positions + directions * sd, positions)
            if bounding_radius:
                inside = torch.linalg.vector_norm(positions, dim=-1, keepdim=True)
                fg = fg & (inside < bounding_radius)
            conv = torch.abs(sd) < convergence_criteria
            trips += 1
    return positions, conv, trips, sd


def sphere_tracing(sdf_fn: Callable[[torch.Tensor], torch.Tensor], ray_positions,
                   ray_directions, num_iterations: int, convergence_criteria: float,
                   foreground_masks=None, bounding_radius: float | None = None,
                   initialization: bool = True, differentiable: bool = False, march=None):
    """Fixed-point SDF ray marching. ``sdf_fn`` maps ``[..., 3] -> [..., 1]``.

    The march is ``march(positions, directions, foreground [..., 1]) ->
    (positions, converged [..., 1], trips)`` when given (``scene.march``,
    the sphere-trace kernel on the card), else ``march_loop`` over all rays
    as one frame. With ``differentiable`` the converged points take the
    implicit-function step ``-sd / <grad sd, dir>`` along their ray, whose
    gradient reaches the field's parameters. Returns ``(positions,
    converged [..., 1])``."""
    if foreground_masks is None:
        foreground_masks = torch.all(torch.isfinite(ray_positions), dim=-1, keepdim=True)
    if bounding_radius and initialization:
        near, _, hit = sphere_intersection(ray_positions, ray_directions, bounding_radius)
        ray_positions = torch.where(hit, ray_positions + ray_directions * near, ray_positions)
        foreground_masks = foreground_masks & hit

    if march is None:
        positions, converged = march_loop(
            sdf_fn, ray_positions, ray_directions, foreground_masks, num_iterations,
            convergence_criteria, bounding_radius)[:2]
    else:
        positions, converged, _ = march(ray_positions.detach(), ray_directions.detach(),
                                        foreground_masks)

    if differentiable:
        sd, grads = _sdf_with_gradient(sdf_fn, positions)
        step = -sd / torch.sum(grads * ray_directions, dim=-1, keepdim=True)
        positions = torch.where(converged, positions + ray_directions * step, positions)
    return positions, converged


def _sdf_with_gradient(sdf_fn, positions):
    """``(sd [..., 1], grad_x sd [..., 3])`` at constant points; both keep
    their graph to the field's parameters while gradients are enabled."""
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        sd = sdf_fn(pos)
        (grads,) = torch.autograd.grad(sd.sum(), pos, create_graph=keep_graph)
    if not keep_graph:
        sd = sd.detach()
    return sd, grads


def surface_gradient(sdf_fn, positions):
    """d sdf / d position at ``positions [..., 3]``, differentiable with
    respect to the field's parameters."""
    return _sdf_with_gradient(sdf_fn, positions)[1]


def surface_normal(sdf_fn, surface_positions, finite_difference_epsilon: float | None = None):
    """Unit surface normals by autograd, or by central differences with
    ``finite_difference_epsilon``."""
    if finite_difference_epsilon:
        eps = finite_difference_epsilon
        offsets = torch.eye(3, dtype=surface_positions.dtype,
                            device=surface_positions.device) * eps
        normals = torch.cat(
            [sdf_fn(surface_positions + offsets[i]) - sdf_fn(surface_positions - offsets[i])
             for i in range(3)],
            dim=-1,
        )
    else:
        normals = surface_gradient(sdf_fn, surface_positions)
    return normals / torch.clamp(torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
                                 min=1e-12)


def phong_shading(ray_directions, surface_normals, light_directions, light_ambient_colors,
                  light_diffuse_colors, light_specular_colors, material_ambient_colors,
                  material_diffuse_colors, material_specular_colors, material_emission_colors,
                  material_shininesses):
    """The Phong reflection model, clipped to [0, 1]."""

    def normalize(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)

    ray_directions = normalize(ray_directions)
    surface_normals = normalize(surface_normals)
    light_directions = normalize(light_directions)
    cosine = torch.sum(light_directions * surface_normals, dim=-1, keepdim=True)
    reflected = light_directions - 2.0 * surface_normals * cosine
    diffuse = F.relu(-cosine)
    specular = F.relu(-torch.sum(reflected * ray_directions, dim=-1, keepdim=True)
                      ) ** material_shininesses
    colors = (
        material_emission_colors
        + material_ambient_colors * light_ambient_colors
        + material_diffuse_colors * light_diffuse_colors * diffuse
        + material_specular_colors * light_specular_colors * specular
    )
    return torch.clamp(colors, 0.0, 1.0)


def shadow_rendering(sdf_fn, surface_positions, surface_normals, light_directions,
                     num_iterations: int, convergence_criteria: float, foreground_masks,
                     bounding_radius: float | None = None, initialization: bool = False,
                     march=None):
    """Hard shadows: march from each surface point towards the light; a
    point is shadowed where that march converges on a surface."""
    ray_positions = surface_positions + surface_normals * convergence_criteria
    _, converged = sphere_tracing(
        sdf_fn, ray_positions, -light_directions, num_iterations, convergence_criteria,
        foreground_masks=foreground_masks, bounding_radius=bounding_radius,
        initialization=initialization, march=march)
    return foreground_masks & converged
