"""Full-image renders of one view for logging and visual checks.

Counterpart of ``vsrd_tpu/pipeline/render_image.py``: per-pixel instance
probabilities (volumetric, through K1 in row chunks) and the sphere-traced
convergence mask of every pixel (one launch of the sphere-trace kernel on
the card). Both use the softmin scene field of the step, with the residual
field from the warmup's end on, and run without gradients.
"""

from __future__ import annotations

import torch

from ..models import box_parameters, hyper_field
from ..rendering import field_kernels, renderer, scene
from .frame import FrameData, ray_directions_at
from .optimize import OptimizationConfig, cosine_annealing


def _scene(params, frame: FrameData, step: int, cfg: OptimizationConfig):
    """The step's scene parameters, union temperature and NeuS std."""
    decoded = box_parameters.decode_boxes(params["boxes"])
    progress = torch.tensor(step, dtype=torch.float32, device=frame.device) / cfg.num_steps
    temperature = cosine_annealing(progress, cfg.max_sdf_union_temperature,
                                   cfg.min_sdf_union_temperature)
    std = cosine_annealing(progress, cfg.max_sdf_std_deviation, cfg.min_sdf_std_deviation)
    weights = None
    if step >= cfg.warmup_steps:
        weights = hyper_field.hypernetwork_apply(params["hyper"], decoded["embeddings"])
    params_scene = scene.SceneParams(decoded["locations"], decoded["orientations"],
                                     decoded["dimensions"], frame.valid, weights)
    return params_scene, temperature, std, progress


@torch.no_grad()
def render_instance_probabilities(params, frame: FrameData, step: int,
                                  cfg: OptimizationConfig, view: int = 0,
                                  row_chunk: int = 8) -> torch.Tensor:
    """Volumetric per-pixel instance probabilities ``[H, W, N]`` of one view,
    ``row_chunk`` pixel rows per render (``H`` a multiple of it). Both the
    coarse and the fine pass evaluate the full field with its gradient (K1
    on the card), with deterministic samples."""
    height, width = frame.image_size
    if height % row_chunk:
        raise ValueError("the image height must be a multiple of row_chunk")
    sp, temperature, std, progress = _scene(params, frame, step, cfg)
    valid = sp.valid.to(torch.float32)
    n = frame.max_instances

    def field_with_grad(positions):
        shape = positions.shape[:-1]
        u, w, g = field_kernels.fused_field_with_grad(
            positions.reshape(-1, 3), sp.locations, sp.rotations, sp.half_dimensions, valid,
            sp.field_weights, temperature, cfg.position_scale)
        return u.reshape(shape), w.reshape(*shape, n), g.reshape(*shape, 3)

    base = view * height * width
    rows = []
    for row0 in range(0, height, row_chunk):
        idx = base + row0 * width + torch.arange(row_chunk * width, device=frame.device)
        origins, directions = ray_directions_at(frame, idx)
        out = renderer.hierarchical_render(
            origins, directions, cfg.distance_range, cfg.num_samples, std, progress,
            field_with_grad=field_with_grad, deterministic=True)
        rows.append(out.features)
    return torch.cat(rows).reshape(height, width, -1)


@torch.no_grad()
def render_surface_mask(params, frame: FrameData, step: int, cfg: OptimizationConfig,
                        view: int = 0) -> torch.Tensor:
    """Sphere-traced convergence mask ``[H, W]`` (bool) of every pixel of one
    view, through the softmin union at the step's temperature."""
    height, width = frame.image_size
    sp, temperature, _, _ = _scene(params, frame, step, cfg)
    idx = view * height * width + torch.arange(height * width, device=frame.device)
    origins, directions = ray_directions_at(frame, idx)
    field = scene.soft_scene_field(sp, temperature, cfg.position_scale)

    def march(positions, dirs, foreground):
        return scene.march(sp, positions, dirs, foreground, cfg.surface_num_iterations,
                           cfg.surface_convergence_criteria, cfg.surface_bounding_radius,
                           temperature=float(temperature), position_scale=cfg.position_scale)

    _, converged = renderer.sphere_tracing(
        lambda p: scene.batched_sdf(field, p), origins, directions,
        cfg.surface_num_iterations, cfg.surface_convergence_criteria,
        bounding_radius=cfg.surface_bounding_radius, initialization=False, march=march)
    return converged[..., 0].reshape(height, width)
