"""Geometric operations the loss uses: rotations, point transforms and box
projection with front clipping.

Counterpart of the same functions in ``vsrd_tpu/ops/geometry.py``,
batched over leading dimensions instead of ``vmap``-ed.
"""

from __future__ import annotations

import torch

# 12 box edges in the KITTI-360 "evaluation" corner order.
LINE_INDICES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def _rotation_stack(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_matrix_x(angles) -> torch.Tensor:
    angles = torch.as_tensor(angles, dtype=torch.float32)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rotation_stack([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rotation_matrix_y(angles) -> torch.Tensor:
    angles = torch.as_tensor(angles, dtype=torch.float32)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rotation_stack([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rotation_matrix_y_from_cos_sin(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Y-axis rotation from (cos, sin) pairs."""
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    return _rotation_stack([[cos, zero, sin], [zero, one, zero], [-sin, zero, cos]])


def transform_points(matrices: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ...x4x4 homogeneous transforms to ...xKx3 points."""
    points_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    out = torch.einsum("...mn,...kn->...km", matrices, points_h)
    return out[..., :3] / out[..., 3:]


def clip_lines_to_front(lines: torch.Tensor, epsilon: float = 1e-6):
    """Clip camera-space segments ``[..., 2, 3]`` to the z>0 half space.

    Returns the clipped segments and a mask of lines with at least one
    point in front.
    """
    points_1 = lines[..., 0, :]
    points_2 = lines[..., 1, :]
    depths_1 = points_1[..., -1:]
    depths_2 = points_2[..., -1:]

    front_first = depths_1 > depths_2
    near = torch.where(front_first, points_2, points_1)
    far = torch.where(front_first, points_1, points_2)
    near_d = torch.where(front_first, depths_2, depths_1)
    far_d = torch.where(front_first, depths_1, depths_2)

    weights = far_d / torch.clamp(far_d - near_d, min=epsilon)
    weights = torch.clamp(weights, max=1.0)
    near = far + (near - far) * weights

    clipped = torch.stack([far, near], dim=-2)
    masks = far[..., -1] > 0
    return clipped, masks


def project_box_3d(
    box_3d: torch.Tensor,
    intrinsic_matrix: torch.Tensor,
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """Project camera-space 8-corner boxes ``[..., 8, 3]`` to 2D boxes
    ``[..., 2, 2]`` (``[[x0, y0], [x1, y1]]``) with front clipping.

    ``intrinsic_matrix [..., 3, 3]`` broadcasts against the box batch.
    Boxes entirely behind the camera project to zeros.
    """
    idx = torch.tensor(LINE_INDICES, device=box_3d.device)
    lines = box_3d[..., idx, :]  # [..., 12, 2, 3]
    lines, masks = clip_lines_to_front(lines, epsilon)

    k = intrinsic_matrix[..., None, None, :, :]           # [..., 1, 1, 3, 3]
    pix = torch.sum(k * lines[..., None, :], dim=-1)       # lines @ K^T
    pix = pix[..., :-1] / torch.clamp(pix[..., -1:], min=epsilon)  # [..., 12, 2, 2]

    valid = masks[..., None, None]  # [..., 12, 1, 1]
    big = torch.finfo(pix.dtype).max
    mins = torch.amin(torch.where(valid, pix, big), dim=(-3, -2))
    maxs = torch.amax(torch.where(valid, pix, -big), dim=(-3, -2))

    any_valid = torch.any(masks, dim=-1)[..., None]
    zero = torch.zeros((), dtype=pix.dtype, device=pix.device)
    return torch.stack(
        [torch.where(any_valid, mins, zero), torch.where(any_valid, maxs, zero)],
        dim=-2,
    )


def clip_boxes_to_image(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clamp ``[..., 2, 2]`` boxes to ``[0, W] x [0, H]``."""
    height, width = image_size
    x = torch.clamp(boxes[..., 0], 0.0, float(width))
    y = torch.clamp(boxes[..., 1], 0.0, float(height))
    return torch.stack([x, y], dim=-1)
