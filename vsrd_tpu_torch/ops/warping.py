"""Depth-based view warping and splatting, and correlation costs (NCHW).

Counterpart of ``vsrd_tpu/ops/warping.py``: backward warping gathers with
bilinear ``grid_sample``; forward warping scatters with bilinear
splatting, whose sums go through ``index_add`` (atomics on the card, so
their order, and the last bits of a pixel hit by several sources, may
change from run to run).
"""

from __future__ import annotations

import torch

from .geometry import backprojection, projection
from .grid_sample import grid_sample_nchw


def _linear_map(values, in_min, in_max, out_min, out_max):
    return (values - in_min) / (in_max - in_min) * (out_max - out_min) + out_min


def backward_warping(source_feature_maps, target_depth_maps, source_intrinsic_matrices,
                     target_intrinsic_matrices, source_extrinsic_matrices=None,
                     target_extrinsic_matrices=None, epsilon=1e-6):
    """Source features ``[B, C, H, W]`` sampled at the reprojections of the
    target pixels at their depths ``[B, 1, H, W]``."""
    coords = backprojection(target_depth_maps[:, 0], target_intrinsic_matrices,
                            target_extrinsic_matrices)                     # [B, H, W, 4]
    pix = projection(coords, source_intrinsic_matrices[:, None, None],
                     None if source_extrinsic_matrices is None
                     else source_extrinsic_matrices[:, None, None])        # [B, H, W, 3]
    h, w = source_feature_maps.shape[-2:]
    x = _linear_map(pix[..., 0] / (pix[..., 2] + epsilon), 0, w - 1, -1.0, 1.0)
    y = _linear_map(pix[..., 1] / (pix[..., 2] + epsilon), 0, h - 1, -1.0, 1.0)
    return grid_sample_nchw(source_feature_maps, torch.stack([x, y], dim=-1),
                            align_corners=True)


def grid_splatting(inputs, coords, image_size=None, epsilon=1e-6):
    """Bilinear scatter of features ``[B, C, H, W]`` to target pixel coords
    ``[B, H, W, 2]`` (x, y), each target pixel divided by its summed
    weight; ``image_size`` (H', W') of the target, by default the input's."""
    b, c, h, w = inputs.shape
    out_h, out_w = image_size or (h, w)
    size = out_h * out_w
    x = coords[..., 0].reshape(b, -1)
    y = coords[..., 1].reshape(b, -1)
    features = inputs.reshape(b, c, -1)
    base = (torch.arange(b, device=inputs.device) * size)[:, None]
    x0, y0 = torch.floor(x), torch.floor(y)
    out = inputs.new_zeros(c, b * size)
    weight = inputs.new_zeros(b * size)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1.0 - torch.abs(xi - x)) * (1.0 - torch.abs(yi - y))
            inside = (xi >= 0) & (xi < out_w) & (yi >= 0) & (yi < out_h)
            wgt = torch.where(inside, wgt, 0.0)
            idx = (torch.clamp(yi, 0, out_h - 1) * out_w + torch.clamp(xi, 0, out_w - 1)).long()
            idx = (idx + base).reshape(-1)
            contrib = (features * wgt[:, None]).permute(1, 0, 2).reshape(c, -1)
            out = out.index_add(1, idx, contrib)
            weight = weight.index_add(0, idx, wgt.reshape(-1))
    out = out / torch.clamp(weight, min=epsilon)
    return out.reshape(c, b, out_h, out_w).permute(1, 0, 2, 3)


def forward_warping(source_feature_maps, source_depth_maps, source_intrinsic_matrices,
                    target_intrinsic_matrices, source_extrinsic_matrices=None,
                    target_extrinsic_matrices=None, epsilon=1e-6):
    """Source features splatted to their reprojections in the target view."""
    coords = backprojection(source_depth_maps[:, 0], source_intrinsic_matrices,
                            source_extrinsic_matrices)
    pix = projection(coords, target_intrinsic_matrices[:, None, None],
                     None if target_extrinsic_matrices is None
                     else target_extrinsic_matrices[:, None, None])
    xy = pix[..., :2] / (pix[..., 2:] + epsilon)
    return grid_splatting(source_feature_maps, xy)


def _unit(x, dim):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def correlation(target_features, source_features, normalize=False, keepdims=False):
    """Mean channel correlation ``[B, (1,) H, W]`` of two ``[B, C, H, W]`` maps."""
    if normalize:
        target_features = _unit(target_features, 1)
        source_features = _unit(source_features, 1)
    return torch.mean(target_features * source_features, dim=1, keepdim=keepdims)


def groupwise_correlation(target_features, source_features, num_groups, normalize=False,
                          keepdims=False):
    """Correlation per channel group: ``[B, G, (1,) H, W]``."""
    b, c = target_features.shape[:2]
    shape = (b, num_groups, c // num_groups, *target_features.shape[2:])
    t = target_features.reshape(shape)
    s = source_features.reshape(shape)
    if normalize:
        t, s = _unit(t, 2), _unit(s, 2)
    return torch.mean(t * s, dim=2, keepdim=keepdims)
