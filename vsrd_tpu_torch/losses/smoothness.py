"""Edge-aware and motion smoothness losses (NCHW).

Counterpart of ``vsrd_tpu/losses/smoothness.py``. The image gradients pad
the last row or column by repeating it (edge padding), so they are zero
there.
"""

from __future__ import annotations

import torch

from .utils import reduced


def gradient_x(inputs):
    padded = torch.cat([inputs, inputs[..., :, -1:]], dim=-1)
    return padded[..., :, 1:] - padded[..., :, :-1]


def gradient_y(inputs):
    padded = torch.cat([inputs, inputs[..., -1:, :]], dim=-2)
    return padded[..., 1:, :] - padded[..., :-1, :]


@reduced
def smoothness_loss(inputs, references, normalize=True, epsilon=1e-6):
    if normalize:
        inputs = inputs / (torch.mean(inputs, dim=(-2, -1), keepdim=True) + epsilon)
    gx = torch.abs(gradient_x(inputs))
    gy = torch.abs(gradient_y(inputs))
    wx = torch.exp(-torch.mean(torch.abs(gradient_x(references)), dim=1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gradient_y(references)), dim=1, keepdim=True))
    return gx * wx + gy * wy


@reduced
def motion_smoothness_loss(inputs, epsilon=1e-6):
    gx = torch.abs(gradient_x(inputs))
    gy = torch.abs(gradient_y(inputs))
    return torch.sqrt(gx**2.0 + gy**2.0 + epsilon)


@reduced
def motion_sparsity_loss(inputs, epsilon=1e-6):
    means = torch.mean(torch.abs(inputs), dim=(-2, -1), keepdim=True).detach()
    return torch.sqrt(torch.abs(inputs) * means + means * means + epsilon)
