"""Photometric image losses: SSIM and its blend with the Huber loss.

Counterpart of ``vsrd_tpu/losses/photometric.py``. Images are NCHW; the
SSIM statistics are 3x3 average pools over reflect-padded images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.iou2d import smooth_l1
from .utils import reduced


@reduced
def ssim_loss(inputs, targets, C1=0.01**2, C2=0.03**2, kernel_size=3, stride=1, padding=1):
    """(1 - SSIM) / 2 per pixel, clipped to [0, 1]."""
    pad = (padding,) * 4
    x = F.pad(inputs, pad, mode="reflect")
    y = F.pad(targets, pad, mode="reflect")

    def pool(z):
        return F.avg_pool2d(z, kernel_size, stride)

    mu_x = pool(x)
    mu_y = pool(y)
    sigma_xx = pool(x * x) - mu_x * mu_x
    sigma_yy = pool(y * y) - mu_y * mu_y
    sigma_xy = pool(x * y) - mu_x * mu_y

    luminance = (2.0 * mu_x * mu_y + C1) / (mu_x * mu_x + mu_y * mu_y + C1)
    contrast_structure = (2.0 * sigma_xy + C2) / (sigma_xx + sigma_yy + C2)
    return torch.clamp((1.0 - luminance * contrast_structure) / 2.0, 0.0, 1.0)


@reduced
def photometric_loss(inputs, targets, alpha=0.75):
    """alpha SSIM loss + (1 - alpha) smooth L1, per pixel."""
    ssim = ssim_loss(inputs, targets, reduction="none")
    huber = smooth_l1(inputs, targets)
    return ssim * alpha + huber * (1.0 - alpha)
