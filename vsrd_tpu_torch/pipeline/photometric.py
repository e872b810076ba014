"""Multi-view photometric consistency loss: sphere-traced surfels, plane
homography patch warps and cross-view correlation.

Counterpart of ``vsrd_tpu/pipeline/photometric.py``. Surface rays are drawn
from the target view's binarized sampling map and sphere-traced on the
hard (argmin) union of the scene; each converged surfel induces a plane
homography from the target view into every view, which warps an 11x11
grayscale patch around its pixel by bilinear sampling; the loss is (1 -
the mean of each view's top-4 cross-view patch correlations) / 2 over the
converged surfels, and 0 when none converged.

The march is one launch of the sphere-trace kernel on the card for all
stacked frames (``scene.march``); the implicit-function step and the
normals evaluate the hard field eagerly at the (at most ``num_rays``)
surfels, with gradients to the boxes and the hypernetwork. Stacked frames
(a leading frame axis on ``frame`` and ``scene``) give a loss per frame.
"""

from __future__ import annotations

import functools

import torch

from ..ops import sampling
from ..ops.grid_sample import grid_sample_nchw
from ..rendering import renderer, scene as scene_mod
from .frame import FrameData, ray_directions_at


def _linear_map(values, in_min, in_max, out_min, out_max):
    return (values - in_min) / (in_max - in_min) * (out_max - out_min) + out_min


def masked_corrcoef(patches: torch.Tensor, epsilon: float = 1e-12) -> torch.Tensor:
    """Row-wise correlation matrix of ``[..., V, D]`` -> ``[..., V, V]``."""
    centered = patches - torch.mean(patches, dim=-1, keepdim=True)
    cov = centered @ centered.transpose(-1, -2) / (patches.shape[-1] - 1)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    denom = torch.sqrt(var[..., :, None] * var[..., None, :] + epsilon)
    return cov / denom


def _at_target(x: torch.Tensor, frame: FrameData) -> torch.Tensor:
    """``x [(F,) V, ...]`` in each frame's target view."""
    if frame.num_frames is None:
        return x[frame.target_index]
    return x[torch.arange(frame.num_frames, device=x.device), frame.target_index]


def surface_indices(frame: FrameData, num_rays: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Draw ``num_rays`` distinct target-view pixels (flat y * W + x) from
    the target's sampling map binarized at 0.5: ``[(F,) R]``, one draw per
    frame."""
    height, width = frame.image_size
    maps = frame.sampling_weights.reshape(*frame.valid.shape[:-1], -1, height * width)
    hard = (_at_target(maps, frame) > 0.5).to(torch.float32)
    return sampling.multinomial_no_replacement(hard, num_rays, generator)


def photometric_loss(
    frame: FrameData,
    scene: scene_mod.SceneParams,
    generator: torch.Generator | None = None,
    num_rays: int = 100,
    num_iterations: int = 1000,
    convergence_criteria: float = 0.01,
    bounding_radius: float = 100.0,
    patch_size: tuple[int, int] = (11, 11),
    top_k: int = 4,
    local_idx: torch.Tensor | None = None,
    position_scale: float = 100.0,
):
    """The photometric loss ``[(F,)]`` and the surfels' convergence ``[(F,)
    R]``. Requires ``frame.gray_images``. ``local_idx [(F,) R]`` (target-view
    pixel indices) replaces the draw from ``generator``."""
    if frame.gray_images is None:
        raise ValueError("the photometric loss needs frame.gray_images")
    height, width = frame.image_size
    stacked = frame.num_frames is not None
    tgt = frame.target_index
    if local_idx is None:
        local_idx = surface_indices(frame, num_rays, generator)
    local_idx = local_idx.long()
    view_offset = (tgt[:, None] if stacked else tgt) * (height * width)
    origins, directions = ray_directions_at(frame, view_offset + local_idx)

    # ---- sphere trace the hard union ----
    hard_field = scene_mod.hard_scene_field(scene, position_scale)

    def sdf_fn(positions):
        return scene_mod.batched_sdf(hard_field, positions)

    march = functools.partial(
        scene_mod.march, scene, num_iterations=num_iterations,
        convergence_criteria=convergence_criteria, bounding_radius=bounding_radius,
        position_scale=position_scale)
    positions, converged = renderer.sphere_tracing(
        sdf_fn, origins, directions, num_iterations, convergence_criteria,
        bounding_radius=bounding_radius, initialization=False, differentiable=True,
        march=march)
    normals = renderer.surface_normal(sdf_fn, positions.detach())
    converged = converged[..., 0]                                        # [(F,) R]

    # ---- the patch pixel grid around each target pixel ----
    ph, pw = patch_size
    device = origins.device
    gy, gx = torch.meshgrid(
        torch.arange(ph, dtype=torch.float32, device=device) - ph // 2,
        torch.arange(pw, dtype=torch.float32, device=device) - pw // 2,
        indexing="ij")
    px = (local_idx % width).to(torch.float32)
    py = (local_idx // width).to(torch.float32)
    coords = torch.stack([px[..., None, None] + gx, py[..., None, None] + gy], dim=-1)
    coords_h = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)  # [(F,) R, ph, pw, 3]

    # ---- plane-induced homographies into every view ----
    # H = Ks (Rs Rt^T - Rs (Rs^T ts - Rt^T tt) n^T / -(n^T p)) Kt^-1
    k_t = _at_target(frame.intrinsics, frame)
    e_t = _at_target(frame.extrinsics, frame)
    r_t = e_t[..., None, :3, :3]                                         # [(F,) 1, 3, 3]
    t_t = e_t[..., None, :3, 3:]
    inv_k_t = torch.linalg.inv_ex(k_t).inverse[..., None, None, :, :]   # no sync on a check
    r_s = frame.extrinsics[..., :3, :3]                                  # [(F,) V, 3, 3]
    t_s = frame.extrinsics[..., :3, 3:]
    n_dot_p = torch.sum(normals * positions, dim=-1)                     # [(F,) R]
    base = r_s @ r_t.transpose(-1, -2)
    offset = r_s @ (r_s.transpose(-1, -2) @ t_s - r_t.transpose(-1, -2) @ t_t)  # [(F,) V, 3, 1]
    outer = offset[..., :, None, :, :] * normals[..., None, :, None, :]  # [(F,) V, R, 3, 3]
    mats = base[..., None, :, :] - outer / (-n_dot_p)[..., None, :, None, None]
    homographies = frame.intrinsics[..., None, :, :] @ mats @ inv_k_t    # [(F,) V, R, 3, 3]

    source = torch.einsum("...vrij,...rhwj->...vrhwi", homographies, coords_h)
    source_xy = source[..., :2] / (source[..., 2:] + 1e-6)
    normalized = torch.stack([
        _linear_map(source_xy[..., 0], 0.0, width - 1.0, -1.0, 1.0),
        _linear_map(source_xy[..., 1], 0.0, height - 1.0, -1.0, 1.0),
    ], dim=-1)                                                           # [(F,) V, R, ph, pw, 2]
    lead = normalized.shape[:-4]
    gray = frame.gray_images.reshape(-1, 1, height, width)
    patches = grid_sample_nchw(gray, normalized.reshape(gray.shape[0], *normalized.shape[-4:]),
                               align_corners=False)
    patches = patches.reshape(*lead, -1, ph * pw)                        # [(F,) V, R, D]

    # ---- cross-view correlation, top-k per view ----
    k = min(top_k, patches.shape[-3])
    corr = masked_corrcoef(patches.transpose(-2, -3))                    # [(F,) R, V, V]
    tops = torch.topk(corr, k, dim=-1).values                            # [(F,) R, V, k]
    mask = converged[..., None, None] & torch.isfinite(tops)
    safe = torch.where(mask, tops, 0.0)
    dims = (-3, -2, -1)
    mean = torch.sum(safe, dim=dims) / torch.clamp(torch.sum(mask, dim=dims), min=1)
    loss = (1.0 - mean) / 2.0
    return torch.where(torch.any(converged, dim=-1), loss, 0.0), converged
