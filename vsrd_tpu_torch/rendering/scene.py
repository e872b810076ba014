"""Scene fields off the kernels: the soft and hard unions of every instance's
box SDF plus its residual field, as plain PyTorch functions of points.

Counterpart of ``vsrd_tpu/rendering/scene.py``. The per-instance math is
``fused_field.instance_distances`` (the kernels' plain twin), the unions
are ``sdf.masked_softmin_union`` and ``sdf.masked_hard_union``. The JAX
package's block-diagonal ``packed_weights`` and its ``field_dtype`` shape
the field for the TPU's matrix unit and are not carried over: the field
takes the flat per-instance weights and runs in f32.

Every function also takes F stacked frames: parameters with a leading
frame axis ``[F, N, ...]`` and points ``[F, ..., 3]``.

Field contract: ``field(positions [(F,) ..., 3]) -> (sdf [(F,) ...],
weights [(F,) ..., N])``.

``march`` is the gradient-stopped sphere-tracing march through a scene's
hard (or soft) union: on CUDA tensors ONE launch of the sphere-trace
kernel for every frame (``field_kernels.sphere_trace``), on CPU tensors
its plain twin, ``renderer.march_loop`` per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import field_kernels, fused_field, renderer, sdf as sdf_ops


class SceneParams(NamedTuple):
    """Decoded, padded per-instance scene parameters, with an optional
    leading frame axis. ``field_weights`` is None in the box-only warmup
    phase and the flat hypernetwork output ``[(F,) N, 1617]`` afterwards."""

    locations: torch.Tensor        # [(F,) N, 3]
    rotations: torch.Tensor        # [(F,) N, 3, 3]
    half_dimensions: torch.Tensor  # [(F,) N, 3]
    valid: torch.Tensor            # [(F,) N] bool
    field_weights: torch.Tensor | None = None


def instance_distances(scene: SceneParams, positions: torch.Tensor,
                       position_scale: float = 100.0, num_frequencies: int = 8,
                       out_channels_list=(16, 16, 16, 16)) -> torch.Tensor:
    """Per-instance signed distances ``[(F,) ..., 3] -> [(F,) ..., N]``."""
    frames = scene.valid.shape[:-1]
    shape = positions.shape[:-1]
    flat = positions.reshape(*frames, -1, 3)
    layers = None
    if scene.field_weights is not None:
        layers = fused_field.split_field_layers(
            scene.field_weights, in_channels=6 * num_frequencies,
            out_channels_list=out_channels_list)
    distances = fused_field.instance_distances(
        flat, scene.locations, scene.rotations, scene.half_dimensions, layers,
        position_scale, num_frequencies)
    return distances.reshape(*shape, distances.shape[-1])


def _valid_at(scene: SceneParams, ndim: int) -> torch.Tensor:
    """``valid [(F,) N]`` shaped to broadcast against ``[(F,) ..., N]``."""
    frames = scene.valid.shape[:-1]
    lead = ndim - 1 - len(frames)
    return scene.valid.reshape(*frames, *([1] * lead), scene.valid.shape[-1])


def soft_scene_field(scene: SceneParams, temperature, position_scale: float = 100.0,
                     num_frequencies: int = 8, out_channels_list=(16, 16, 16, 16)):
    """Softmin-union field for the volumetric renderer. The softmin weights
    double as the instance one-hot features. Padded instances are masked
    as the kernels mask them (``(valid - 1) * 1e30`` on the logits), so a
    frame with no valid instance gets uniform weights where the JAX
    package's ``-inf`` mask gives NaN."""

    def field(positions):
        distances = instance_distances(scene, positions, position_scale,
                                       num_frequencies, out_channels_list)
        valid = _valid_at(scene, distances.ndim).to(distances.dtype)
        return sdf_ops.masked_softmin_union(distances, valid, temperature)

    return field


def hard_scene_field(scene: SceneParams, position_scale: float = 100.0,
                     num_frequencies: int = 8, out_channels_list=(16, 16, 16, 16)):
    """Argmin-union field (surface rendering)."""

    def field(positions):
        distances = instance_distances(scene, positions, position_scale,
                                       num_frequencies, out_channels_list)
        return sdf_ops.masked_hard_union(distances, _valid_at(scene, distances.ndim))

    return field


def batched_sdf(field, positions: torch.Tensor) -> torch.Tensor:
    """SDF-only adapter for sphere tracing: ``[..., 3] -> [..., 1]``."""
    return field(positions)[0][..., None]


def frame_scene(scene: SceneParams, index: int) -> SceneParams:
    """Frame ``index`` of stacked scene parameters."""
    return SceneParams(*(None if t is None else t[index] for t in scene))


def march(scene: SceneParams, positions, directions, foreground_masks, num_iterations: int,
          convergence_criteria: float, bounding_radius: float | None = None,
          temperature=None, position_scale: float = 100.0):
    """The march of ``renderer.sphere_tracing`` through the scene's hard
    union, or its softmin union at ``temperature``, frame by frame: each
    frame stops on its own. Rays ``[(F,) R, 3]`` (the frame axis as on the
    scene), ``foreground_masks [(F,) R, 1]`` bool. Returns ``(positions,
    converged [(F,) R, 1], trips [F] int32)``.

    CUDA tensors launch the sphere-trace kernel once for all frames (or
    raise); CPU tensors run ``renderer.march_loop`` per frame."""
    radius = float(bounding_radius or 0.0)
    frames = scene.valid.shape[:-1]
    if positions.device.type == "cuda":
        out, conv, trips, _ = field_kernels.sphere_trace(
            positions, directions, foreground_masks[..., 0], scene.locations,
            scene.rotations, scene.half_dimensions, scene.valid.to(torch.float32),
            None if scene.field_weights is None else scene.field_weights.detach(),
            num_iterations, convergence_criteria, radius, temperature, position_scale)
        return out, conv[..., None], trips
    if positions.device.type != "cpu":
        raise ValueError(f"no sphere-trace kernel for device {positions.device}")
    per_frame = [frame_scene(scene, f) for f in range(frames[0])] if frames else [scene]
    results = []
    for index, one in enumerate(per_frame):
        if temperature is None:
            field = hard_scene_field(one, position_scale)
        else:
            field = soft_scene_field(one, temperature, position_scale)
        pick = (lambda t: t[index]) if frames else (lambda t: t)  # noqa: E731
        results.append(renderer.march_loop(
            lambda p, field=field: batched_sdf(field, p), pick(positions), pick(directions),
            pick(foreground_masks), num_iterations, convergence_criteria, radius)[:3])
    trips = torch.tensor([r[2] for r in results], dtype=torch.int32)
    if not frames:
        return results[0][0], results[0][1], trips
    return (torch.stack([r[0] for r in results]), torch.stack([r[1] for r in results]), trips)
