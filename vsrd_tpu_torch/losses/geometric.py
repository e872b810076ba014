"""Pose-consistency and epipolar losses.

Counterpart of ``vsrd_tpu/losses/geometric.py``.
"""

from __future__ import annotations

import torch

from ..ops.geometry import homogeneous
from .utils import reduced


@reduced
def rotation_consistency_loss(source_extrinsic_matrices, target_extrinsic_matrices,
                              epsilon=1e-6):
    cycle = target_extrinsic_matrices @ source_extrinsic_matrices
    eye = torch.eye(3, dtype=cycle.dtype, device=cycle.device)

    def consistency(rot):
        return torch.mean(torch.square(rot - eye), dim=(-2, -1))

    return consistency(cycle[..., :3, :3]) / (
        consistency(source_extrinsic_matrices[..., :3, :3])
        + consistency(target_extrinsic_matrices[..., :3, :3]) + epsilon)


@reduced
def translation_consistency_loss(source_extrinsic_matrices, target_extrinsic_matrices,
                                 epsilon=1e-6):
    cycle = target_extrinsic_matrices @ source_extrinsic_matrices

    def consistency(t):
        return torch.mean(torch.square(t), dim=-1)

    return consistency(cycle[..., :3, 3]) / (
        consistency(source_extrinsic_matrices[..., :3, 3])
        + consistency(target_extrinsic_matrices[..., :3, 3]) + epsilon)


@reduced
def sampson_epipolar_distance(keypoints_1, keypoints_2, fundamental_matrices):
    kp1 = homogeneous(keypoints_1)
    kp2 = homogeneous(keypoints_2)
    lines_2 = kp1 @ fundamental_matrices.transpose(-2, -1)
    lines_1 = kp2 @ fundamental_matrices
    algebraic = torch.sum(kp2 * lines_2, dim=-1) ** 2.0
    grad_2 = torch.sum(lines_2[..., :2] ** 2.0, dim=-1)
    grad_1 = torch.sum(lines_1[..., :2] ** 2.0, dim=-1)
    return algebraic / (grad_2 + grad_1)
