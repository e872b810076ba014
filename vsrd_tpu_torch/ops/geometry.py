"""Geometric operations: rotations, homogeneous transforms, projection and
backprojection, epipolar matrices, and box projection with front clipping.

Counterpart of ``vsrd_tpu/ops/geometry.py``, batched over leading
dimensions instead of ``vmap``-ed. Functions of tensors return tensors on
their inputs' device and in their dtype.
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


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def expand_to_4x4(matrices: torch.Tensor) -> torch.Tensor:
    """Embed ``...x3x3`` (or smaller) matrices into homogeneous ``...x4x4``."""
    *batch, rows, cols = matrices.shape
    out = _eye(4, matrices).expand(*batch, 4, 4).clone()
    out[..., :rows, :cols] = matrices
    return out


def skew_symmetric_matrix(vectors: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> the cross-product matrices ``[..., 3, 3]``."""
    x, y, z = vectors.unbind(-1)
    zero = torch.zeros_like(x)
    return _rotation_stack([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


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


def rotation_matrix_z(angles) -> torch.Tensor:
    angles = torch.as_tensor(angles)
    if not angles.is_floating_point():
        angles = angles.to(torch.float32)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rotation_stack([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def rotation_matrix(rotation_axes: torch.Tensor, rotation_angles: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation (Rodrigues): axes ``[..., 3]``, angles ``[...]``."""
    cos = torch.cos(rotation_angles)[..., None, None]
    sin = torch.sin(rotation_angles)[..., None, None]
    outer = rotation_axes[..., :, None] * rotation_axes[..., None, :]
    return ((1.0 - cos) * outer + sin * skew_symmetric_matrix(rotation_axes)
            + cos * _eye(3, rotation_axes))


def translation_matrix(translation_vectors: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> homogeneous translations ``[..., 4, 4]``."""
    *batch, _ = translation_vectors.shape
    out = _eye(4, translation_vectors).expand(*batch, 4, 4).clone()
    out[..., :3, 3] = translation_vectors
    return out


def essential_matrix(rotation_matrices: torch.Tensor,
                     translation_vectors: torch.Tensor) -> torch.Tensor:
    return skew_symmetric_matrix(translation_vectors) @ rotation_matrices


def fundamental_matrix(essential_matrices: torch.Tensor, intrinsic_matrices_1: torch.Tensor,
                       intrinsic_matrices_2: torch.Tensor) -> torch.Tensor:
    inv1 = torch.linalg.inv(intrinsic_matrices_1)
    inv2 = torch.linalg.inv(intrinsic_matrices_2)
    return inv2.transpose(-2, -1) @ essential_matrices @ inv1


def homogeneous(points: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    """Append a homogeneous coordinate along the last axis."""
    return torch.cat([points, torch.full_like(points[..., :1], value)], dim=-1)


def projection(coords: torch.Tensor, intrinsic_matrices: torch.Tensor,
               extrinsic_matrices: torch.Tensor | None = None) -> torch.Tensor:
    """Homogeneous world (or camera) coords ``[..., 4]`` -> ``[..., 3]``
    pixel-space coords (x z, y z, z after K); the matrices broadcast over
    the leading dimensions."""
    if extrinsic_matrices is not None:
        coords = torch.einsum("...mn,...n->...m", extrinsic_matrices, coords)
    coords = coords[..., :-1] / coords[..., -1:]
    return torch.einsum("...mn,...n->...m", intrinsic_matrices, coords)


def backprojection(depth_maps: torch.Tensor, intrinsic_matrices: torch.Tensor,
                   extrinsic_matrices: torch.Tensor | None = None) -> torch.Tensor:
    """Depth maps ``[..., H, W]`` -> homogeneous world coords ``[..., H, W, 4]``."""
    h, w = depth_maps.shape[-2:]
    ys = torch.arange(h, dtype=depth_maps.dtype, device=depth_maps.device)
    xs = torch.arange(w, dtype=depth_maps.dtype, device=depth_maps.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    pixels = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=-1)
    rays = torch.einsum("...mn,hwn->...hwm", torch.linalg.inv(intrinsic_matrices), pixels)
    points = homogeneous(rays * depth_maps[..., None])
    if extrinsic_matrices is not None:
        points = torch.einsum("...mn,...hwn->...hwm", torch.linalg.inv(extrinsic_matrices),
                              points)
    return points


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


def boxes_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., 2, 2]`` min/max boxes -> ``[..., 4]`` (x0, y0, x1, y1)."""
    return boxes.reshape(*boxes.shape[:-2], 4)


def rectification_from_extrinsic(extrinsic_matrix: torch.Tensor) -> torch.Tensor:
    """Gravity rectification from one camera extrinsic ``[4, 4]``: a rotation
    about x by the angle between the camera's y axis and the nearest
    integer axis, signed by the x axis."""
    rot = extrinsic_matrix[..., :3, :3]
    x_axis, y_axis = rot[..., 0, :], rot[..., 1, :]
    y_round = torch.round(y_axis)
    angle = torch.arccos(torch.clamp(torch.sum(y_round * y_axis, dim=-1), -1.0, 1.0))
    angle = angle * torch.sign(torch.sum(torch.linalg.cross(y_round, y_axis) * x_axis, dim=-1))
    return rotation_matrix_x(angle)
