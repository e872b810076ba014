"""2D box IoU, GIoU, DIoU, DIoU loss and smooth L1 (boxes are ``(x0, y0, x1, y1)``).

Counterpart of ``vsrd_tpu/ops/iou2d.py``; the generalized IoU (DETR's box
cost and loss, Rezatofighi et al. 2019) is the port's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_inter_union(boxes1, boxes2):
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, area1[..., :, None] + area2[..., None, :] - inter


def box_iou(boxes1, boxes2, epsilon: float = 0.0):
    """Pairwise IoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    return inter / (union + epsilon)


def elementwise_box_iou(boxes1, boxes2, epsilon: float = 1e-7):
    """Elementwise IoU over matching leading shapes ``[..., 4]``."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1 + area2 - inter + epsilon)


def generalized_box_iou(boxes1, boxes2):
    """Pairwise GIoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``: IoU less
    the share of the enclosing box that the union leaves empty."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return inter / union - (enclosing - union) / enclosing


def elementwise_generalized_box_iou(boxes1, boxes2):
    """Elementwise GIoU over matching leading shapes ``[..., 4]``."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return inter / union - (enclosing - union) / enclosing


def distance_box_iou(boxes1, boxes2, epsilon: float = 1e-7):
    """Pairwise DIoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    iou = box_iou(boxes1, boxes2, epsilon)

    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    diag = torch.sum(torch.square(rb - lt), dim=-1) + epsilon

    c1 = (boxes1[..., :2] + boxes1[..., 2:]) / 2.0
    c2 = (boxes2[..., :2] + boxes2[..., 2:]) / 2.0
    dist = torch.sum(torch.square(c1[..., :, None, :] - c2[..., None, :, :]), dim=-1)
    return iou - dist / diag


def distance_box_iou_loss(boxes1, boxes2, epsilon: float = 1e-7):
    """Elementwise DIoU loss over matching leading shapes ``[..., 4]``."""
    iou = elementwise_box_iou(boxes1, boxes2, epsilon)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    diag = torch.sum(torch.square(rb - lt), dim=-1) + epsilon
    c1 = (boxes1[..., :2] + boxes1[..., 2:]) / 2.0
    c2 = (boxes2[..., :2] + boxes2[..., 2:]) / 2.0
    dist = torch.sum(torch.square(c1 - c2), dim=-1)
    return 1.0 - (iou - dist / diag)


def smooth_l1(inputs, targets, beta: float = 1.0):
    """Elementwise smooth L1 (Huber with ``beta``), as in the JAX package."""
    return F.smooth_l1_loss(inputs, targets, reduction="none", beta=beta)
