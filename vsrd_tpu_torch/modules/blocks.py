"""Network building blocks as ``nn.Module``s on NCHW feature maps.

Counterpart of ``vsrd_tpu/modules/blocks.py``, whose flax modules take
NHWC maps. The blocks compute the same functions on the same weights in
the other layout (``utils/convert.py::blocks_params_from_jax`` carries flax
parameters over):

* ``pixel_unshuffle`` / ``pixel_shuffle`` are ``F.pixel_(un)shuffle``: the
  JAX package's NHWC channel order (c, fy, fx) is the one they give in NCHW;
* ``PackingBlock``'s 3-D convolution runs over (C', H', W') of the
  space-to-depth map with one feature in and ``depth`` out, as flax's runs
  over (H', W', C'), and its output channel is ``c * depth + d`` as the
  flax block flattens it; ``UnpackingBlock`` likewise;
* GroupNorm as flax's: epsilon 1e-6, ``gcd(num_groups, C)`` groups;
* convolutions pad 'same', as flax's SAME.

Randomness is explicit: ``DropPath`` takes a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, scale):
        ctx.scale = scale
        return inputs.view_as(inputs)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_scale(inputs: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; the gradient is scaled by ``scale``."""
    return _GradScale.apply(inputs, scale)


def pixel_unshuffle(inputs: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW space-to-depth: ``[B, C, H, W]`` -> ``[B, C r^2, H/r, W/r]``."""
    return F.pixel_unshuffle(inputs, factor)


def pixel_shuffle(inputs: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW depth-to-space: ``[B, C r^2, H, W]`` -> ``[B, C, H r, W r]``."""
    return F.pixel_shuffle(inputs, factor)


class Scale(nn.Module):
    """Learnable scalar multiplier."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, inputs):
        return self.weight * inputs


class LayerScale(nn.Module):
    """Per-channel learnable scale initialized small; channels on axis 1
    (the JAX package's last axis)."""

    def __init__(self, num_channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_channels,), float(epsilon)))

    def forward(self, inputs):
        shape = (-1,) + (1,) * (inputs.ndim - 2)
        return self.weight.reshape(shape) * inputs


class DropPath(nn.Module):
    """Stochastic depth: drops whole samples with ``drop_prob`` and
    rescales the rest, in training only."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, inputs, deterministic: bool = True,
                generator: torch.Generator | None = None, keep: torch.Tensor | None = None):
        """``keep [B]`` (booleans) replaces the draw from ``generator``."""
        if deterministic or self.drop_prob == 0.0:
            return inputs
        keep_prob = 1.0 - self.drop_prob
        shape = (inputs.shape[0],) + (1,) * (inputs.ndim - 1)
        if keep is None:
            keep = torch.rand(inputs.shape[0], generator=generator,
                              device=inputs.device) < keep_prob
        return inputs * keep.reshape(shape).to(inputs.dtype) / keep_prob


class SqueezeExcitation(nn.Module):
    """Channel gating: global mean, Linear, ReLU, Linear, sigmoid."""

    def __init__(self, in_channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, squeeze_channels)
        self.fc2 = nn.Linear(squeeze_channels, in_channels)

    def forward(self, inputs):
        pooled = torch.mean(inputs, dim=(2, 3))
        gate = torch.sigmoid(self.fc2(F.relu(self.fc1(pooled))))
        return gate[:, :, None, None] * inputs


class Residual(nn.Module):
    """y = x + f(x)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, inputs, *args, **kwargs):
        return inputs + self.fn(inputs, *args, **kwargs)


class Sequential(nn.Module):
    """Chain of callables (``nn.Module``s are registered)."""

    def __init__(self, layers: Sequence[Callable]):
        super().__init__()
        self.layers = list(layers)
        for index, layer in enumerate(self.layers):
            if isinstance(layer, nn.Module):
                self.add_module(str(index), layer)

    def forward(self, inputs, *args, **kwargs):
        x = inputs
        for layer in self.layers:
            x = layer(x)
        return x


def _group_norm(channels: int, num_groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(math.gcd(num_groups, channels), channels, eps=1e-6)


def _depth_conv(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """The 3-D convolution over (C, H, W) with one feature in and ``depth``
    out, flattened to channel ``c * depth + d``."""
    b, c, h, w = x.shape
    y = conv(x[:, None])                                # [B, D, C, H, W]
    return y.transpose(1, 2).reshape(b, c * conv.out_channels, h, w)


class PackingBlock(nn.Module):
    """PackNet-style detail-preserving downsampling: space-to-depth, a 3-D
    convolution over a synthetic depth axis, then a 2-D convolution,
    GroupNorm and ELU."""

    def __init__(self, in_channels: int, out_channels: int, depth: int = 8,
                 kernel_size: int = 3, stride: int = 2, num_groups: int = 16):
        super().__init__()
        self.stride = stride
        self.conv3d = nn.Conv3d(1, depth, kernel_size, padding="same")
        self.conv2d = nn.Conv2d(in_channels * stride**2 * depth, out_channels, kernel_size,
                                padding="same", bias=False)
        self.norm = _group_norm(out_channels, num_groups)

    def forward(self, inputs):
        x = _depth_conv(pixel_unshuffle(inputs, self.stride), self.conv3d)
        return F.elu(self.norm(self.conv2d(x)))


class UnpackingBlock(nn.Module):
    """PackNet-style upsampling: a 2-D convolution, GroupNorm and ELU, a
    3-D convolution over a synthetic depth axis, then depth-to-space."""

    def __init__(self, in_channels: int, out_channels: int, depth: int = 8,
                 kernel_size: int = 3, stride: int = 2, num_groups: int = 16):
        super().__init__()
        self.stride = stride
        mid = out_channels * stride**2 // depth
        self.conv2d = nn.Conv2d(in_channels, mid, kernel_size, padding="same", bias=False)
        self.norm = _group_norm(mid, num_groups)
        self.conv3d = nn.Conv3d(1, depth, kernel_size, padding="same")

    def forward(self, inputs):
        x = F.elu(self.norm(self.conv2d(inputs)))
        return pixel_shuffle(_depth_conv(x, self.conv3d), self.stride)
