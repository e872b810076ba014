"""Classification and mask losses.

Counterpart of ``vsrd_tpu/losses/classification.py``; every loss takes
``reduction={'none','mean','sum'}`` (``utils.reduced``).
"""

from __future__ import annotations

import torch

from .utils import reduced


def _clip01(x, epsilon):
    return torch.clamp(x, epsilon, 1.0 - epsilon)


@reduced
def cross_entropy(inputs, targets, axis=None, keepdims=False, epsilon=1e-6):
    losses = -targets * torch.log(_clip01(inputs, epsilon))
    if axis is not None:
        losses = torch.sum(losses, dim=axis, keepdim=keepdims)
    return losses


@reduced
def binary_cross_entropy(inputs, targets, epsilon=1e-6):
    return (cross_entropy(inputs, targets, epsilon=epsilon, reduction="none")
            + cross_entropy(1.0 - inputs, 1.0 - targets, epsilon=epsilon, reduction="none"))


@reduced
def kl_divergence(inputs, targets, axis=None, keepdims=False, epsilon=1e-6):
    inputs = _clip01(inputs, epsilon)
    targets = _clip01(targets, epsilon)
    losses = -targets * (torch.log(inputs) - torch.log(targets))
    if axis is not None:
        losses = torch.sum(losses, dim=axis, keepdim=keepdims)
    return losses


@reduced
def binary_kl_divergence(inputs, targets, epsilon=1e-6):
    return (kl_divergence(inputs, targets, epsilon=epsilon, reduction="none")
            + kl_divergence(1.0 - inputs, 1.0 - targets, epsilon=epsilon, reduction="none"))


@reduced
def js_divergence(inputs, targets, axis=None, keepdims=False, epsilon=1e-6):
    means = inputs * 0.5 + targets * 0.5
    kw = dict(axis=axis, keepdims=keepdims, epsilon=epsilon, reduction="none")
    return 0.5 * kl_divergence(means, inputs, **kw) + 0.5 * kl_divergence(means, targets, **kw)


@reduced
def binary_js_divergence(inputs, targets, epsilon=1e-6):
    return (js_divergence(inputs, targets, epsilon=epsilon, reduction="none")
            + js_divergence(1.0 - inputs, 1.0 - targets, epsilon=epsilon, reduction="none"))


@reduced
def focal_loss(inputs, targets, alpha=0.25, gamma=2.0):
    """[Focal Loss for Dense Object Detection](https://arxiv.org/abs/1708.02002)."""
    return ((1.0 - torch.abs(targets - alpha)) * torch.abs(targets - inputs) ** gamma
            * binary_cross_entropy(inputs, targets, reduction="none"))


@reduced
def quality_focal_loss(inputs, targets, beta=2.0):
    """[Generalized Focal Loss](https://arxiv.org/abs/2006.04388)."""
    return (torch.abs(targets - inputs) ** beta
            * binary_cross_entropy(inputs, targets, reduction="none"))


@reduced
def tversky_loss(inputs, targets, alpha=0.7, beta=0.3, epsilon=1.0):
    tp = torch.sum(inputs * targets, dim=(-2, -1))
    fn = torch.sum((1.0 - inputs) * targets, dim=(-2, -1))
    fp = torch.sum(inputs * (1.0 - targets), dim=(-2, -1))
    return 1.0 - (tp + epsilon) / (tp + alpha * fn + beta * fp + epsilon)


@reduced
def focal_tversky_loss(inputs, targets, gamma=0.75, **kwargs):
    return tversky_loss(inputs, targets, **kwargs, reduction="none") ** gamma
