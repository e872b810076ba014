"""Diagnostic image panels of the labeling driver, for TensorBoard.

Counterpart of ``vsrd_tpu/visualization/panels.py``:

* ``gt/{k}``: per view, the image with the ground-truth instance masks, the
  ground-truth 3D wireframes and the sampled rays' pixels (red dots);
* ``pd/0``: the target view with the predicted masks (volumetric instance
  probabilities times the sphere-traced surface mask) and the predicted
  wireframes;
* ``bev/0``: a white canvas with the ground-truth footprints (red) and the
  predicted ones (blue), rectified.

Host numpy drawing (``drawers.py``) over the two full-view renders of
``pipeline/render_image.py``, which run on the frame's device; called from
the driver at ``image_intervals``, far off the optimization step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import box_parameters
from ..ops import sampling
from ..pipeline import render_image
from ..pipeline.frame import FrameData
from . import drawers

WIREFRAME_LINES = drawers.LINE_INDICES + [[0, 5], [1, 4]]


def _numpy(tensor) -> np.ndarray:
    return tensor.detach().float().cpu().numpy()


def _base_image(frame: FrameData, view: int) -> np.ndarray:
    h, w = frame.image_size
    if frame.gray_images is not None:
        gray = _numpy(frame.gray_images[view])
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.zeros((h, w, 3), np.float32)


def _view_masks(frame: FrameData, view: int) -> np.ndarray:
    h, w = frame.image_size
    masks = frame.soft_masks_flat.reshape(frame.num_views, h, w, frame.max_instances)[view]
    return _numpy(masks).transpose(2, 0, 1)


def _camera_boxes(world, extrinsic):
    hom = np.concatenate([world, np.ones((len(world), 8, 1))], axis=-1)
    return np.einsum("mn,ikn->ikm", extrinsic, hom)[..., :3]


def diagnostic_panels(params, frame: FrameData, step: int, cfg,
                      ray_indices: torch.Tensor | np.ndarray | None = None) -> dict:
    """``{name: [H, W, 3] float image}``: ``gt/{view - target}`` for every
    view, ``pd/0`` and ``bev/0`` for the target view.

    The red dots are one ray draw of ``cfg.num_rays`` from the frame's
    candidates (a generator seeded with ``step`` on the frame's device),
    shared by all views; ``ray_indices`` (flat (view, y, x) pixel indices)
    replaces the draw."""
    h, w = frame.image_size
    n = frame.max_instances
    valid = _numpy(frame.valid).astype(bool)
    target = int(frame.target_index)
    panels = {}

    if ray_indices is None:
        generator = torch.Generator(device=frame.device).manual_seed(int(step))
        cand = sampling.multinomial_logits(frame.candidate_weights, cfg.num_rays, generator)
        ray_indices = frame.candidate_indices[cand]
    ray_idx = np.asarray(ray_indices.cpu() if isinstance(ray_indices, torch.Tensor)
                         else ray_indices).astype(np.int64)
    views = ray_idx // (h * w)
    ys = (ray_idx % (h * w)) // w
    xs = ray_idx % w

    # f32 as the JAX panels hold them: the BEV footprints are f32 products
    gt_world = _numpy(frame.gt_boxes_3d)                      # target-camera frame
    finite = np.isfinite(gt_world.reshape(n, -1)).all(-1) & valid
    extrinsics = _numpy(frame.extrinsics)
    intrinsics = _numpy(frame.intrinsics)

    for view in range(frame.num_views):
        image = drawers.draw_masks(_base_image(frame, view), _view_masks(frame, view)[valid])
        if finite.any():
            image = drawers.draw_boxes_3d(image, _camera_boxes(gt_world[finite], extrinsics[view]),
                                          intrinsics[view], line_indices=WIREFRAME_LINES,
                                          color=(255, 255, 255))
        sel = views == view
        if sel.any():
            image = drawers.draw_points_2d(image, np.stack([xs[sel], ys[sel]], axis=-1),
                                           color=(255, 0, 0), radius=2)
        panels[f"gt/{view - target:d}"] = image

    # predicted masks and wireframes on the target view
    with torch.no_grad():
        pd_world = _numpy(box_parameters.decode_boxes(params["boxes"])["boxes_3d"])
    pd_masks = _numpy(render_image.render_instance_probabilities(
        params, frame, int(step), cfg, view=target)).transpose(2, 0, 1)
    surf = _numpy(render_image.render_surface_mask(params, frame, int(step), cfg, view=target))
    pd_masks = pd_masks * surf[None]
    image = drawers.draw_masks(_base_image(frame, target), pd_masks[valid])
    panels["pd/0"] = drawers.draw_boxes_3d(
        image, _camera_boxes(pd_world[valid], extrinsics[target]), intrinsics[target],
        line_indices=WIREFRAME_LINES, color=(255, 255, 255))

    # BEV: GT red and predicted blue on a white canvas
    rect = _numpy(frame.rectification)
    canvas = np.ones((1000, 1000, 3), np.float32)
    if finite.any():
        canvas = drawers.draw_boxes_bev(canvas, gt_world[finite] @ rect.T, color=(255, 0, 0))
    panels["bev/0"] = drawers.draw_boxes_bev(canvas, pd_world[valid] @ rect.T, color=(0, 0, 255))
    return panels


def write_panels(writer, panels: dict, step: int) -> None:
    """Log panels to a SummaryWriter as CHW images."""
    for name, image in panels.items():
        writer.add_image(f"images/{name}", np.clip(image, 0.0, 1.0).transpose(2, 0, 1), step)
