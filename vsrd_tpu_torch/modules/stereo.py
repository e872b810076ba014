"""Plane-sweep stereo cost volumes and spatial propagation (NCHW).

Counterpart of ``vsrd_tpu/modules/stereo.py``. The JAX package ``vmap``s
the warp over the depth hypotheses; here they ride the batch axis of one
warp. Its patch extraction (``conv_general_dilated_patches``) is
``F.unfold``, whose (kh, kw) patch order is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.warping import backward_warping, correlation


@dataclass
class PlaneSweepStereo:
    """Multi-view cost volumes over fronto-parallel depth hypotheses.

    ``depth_to_disparity`` / ``disparity_to_depth`` set the hypotheses'
    spacing (by default even in inverse depth); ``cost_function(warped,
    target)`` gives per-pixel costs (by default the feature correlation).
    """

    depth_range: tuple
    num_hypotheses: int
    depth_to_disparity: Callable = lambda depth: 1.0 / depth
    disparity_to_depth: Callable = lambda disparity: 1.0 / disparity
    cost_function: Callable = correlation

    def __call__(self, target, *sources, depth_range=None):
        """``target``/``sources`` are dicts with ``feature_maps [B, C, H, W]``,
        ``intrinsic_matrices [B, 3, 3]``, ``extrinsic_matrices [B, 4, 4]``
        and an optional ``scale`` (feature pyramid level). Returns the mean
        cost over the sources, ``[B, D, H, W]``."""
        target_maps = target["feature_maps"]
        b, _, h, w = target_maps.shape
        like = dict(dtype=target_maps.dtype, device=target_maps.device)
        lo, hi = depth_range or self.depth_range
        disparities = sorted([float(self.depth_to_disparity(lo)),
                              float(self.depth_to_disparity(hi))])
        hypotheses = torch.linspace(disparities[0], disparities[1], self.num_hypotheses, **like)
        depths = self.disparity_to_depth(hypotheses)
        d = self.num_hypotheses

        def scaled_k(inputs):
            scale = 0.5 ** inputs.get("scale", 0)
            diag = torch.tensor([[scale, 0, 0], [0, scale, 0], [0, 0, 1.0]], **like)
            return (diag @ inputs["intrinsic_matrices"]).repeat(d, 1, 1)

        def tiled(matrices):
            return None if matrices is None else matrices.repeat(d, 1, 1)

        # every hypothesis on the batch axis: [D * B, ...], hypothesis-major
        depth_maps = depths.repeat_interleave(b)[:, None, None, None].expand(d * b, 1, h, w)
        target_tiled = target_maps.repeat(d, 1, 1, 1)
        volumes = []
        for source in sources:
            warped = backward_warping(source["feature_maps"].repeat(d, 1, 1, 1), depth_maps,
                                      scaled_k(source), scaled_k(target),
                                      tiled(source.get("extrinsic_matrices")),
                                      tiled(target.get("extrinsic_matrices")))
            volumes.append(self.cost_function(warped, target_tiled).reshape(d, b, h, w))
        return torch.mean(torch.stack(volumes), dim=0).transpose(0, 1)


@dataclass
class SpatialPropagation2d:
    """Anisotropic diffusion with learned affinity kernels (NCHW).

    ``kernels [B, C, KH, KW, H, W]``: per-pixel neighbour affinities; the
    centre weight becomes 1 - sum(neighbours) after L1 normalization.
    """

    kernel_size: int
    num_steps: int = 10
    epsilon: float = 1e-6

    def __call__(self, inputs, kernels):
        pad = (self.kernel_size - 1) // 2
        b, c, kh, kw, h, w = kernels.shape
        mask = torch.ones(kh, kw, dtype=kernels.dtype, device=kernels.device)
        mask[(kh - 1) // 2, (kw - 1) // 2] = 0.0
        neighbors = kernels * mask[None, None, :, :, None, None]
        norm = torch.sum(torch.abs(neighbors), dim=(2, 3), keepdim=True)
        neighbors = neighbors / (norm + self.epsilon)
        centers = 1.0 - torch.sum(neighbors, dim=(2, 3))               # [B, C, H, W]
        outputs = inputs
        for _ in range(self.num_steps):
            patches = F.unfold(outputs.reshape(b * c, 1, h, w), (kh, kw), padding=pad)
            diffused = torch.sum(patches.reshape(b, c, kh, kw, h, w) * neighbors, dim=(2, 3))
            outputs = centers * inputs + diffused
        return outputs
