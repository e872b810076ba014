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

``ResNet50`` (with ``Bottleneck`` and ``FrozenBatchNorm2d``) is the port's
own, DETR's backbone: it has no counterpart in the JAX package.
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


# the calibrated scale of each residual branch's last norm (ResNet50.calibrate_)
RESIDUAL_BRANCH_SCALE = 0.2


class FrozenBatchNorm2d(nn.Module):
    """Batch normalization with fixed statistics and affine terms, all four
    buffers (DETR's ``FrozenBatchNorm2d``, eps 1e-5): ``x * scale + shift``
    with ``scale = weight / sqrt(running_var + eps)`` and ``shift = bias -
    running_mean * scale``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, inputs):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        shift = self.bias - self.running_mean * scale
        return inputs * scale[None, :, None, None] + shift[None, :, None, None]


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (v1.5, the stride on the 3x3): 1x1,
    3x3, 1x1 convolutions without biases to ``4 width`` channels, each with
    ``FrozenBatchNorm2d``, a projected shortcut where the shape changes,
    ReLU after the sum."""

    expansion = 4

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        out_channels = width * self.expansion
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_channels)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out_channels))

    def forward(self, inputs):
        x = F.relu(self.bn1(self.conv1(inputs)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))
        shortcut = inputs if self.downsample is None else self.downsample(inputs)
        return F.relu(x + shortcut)


class ResNet50(nn.Module):
    """torchvision's ResNet-50 trunk as DETR uses it, NCHW in, C5 out
    (2048 channels, stride 32): a 7x7 stride-2 stem with a 3x3 stride-2 max
    pool, then 3-4-6-3 bottlenecks of widths 64, 128, 256, 512 (strides 1,
    2, 2, 2), every norm a ``FrozenBatchNorm2d``. As DETR trains it, the
    stem and ``layer1`` take no gradient (``TRAINED`` lists the rest)."""

    LAYERS = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
    TRAINED = ("layer2", "layer3", "layer4")
    channels = 2048

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        in_channels = 64
        for index, (blocks, width, stride) in enumerate(self.LAYERS, start=1):
            layer = []
            for block in range(blocks):
                layer.append(Bottleneck(in_channels, width, stride if block == 0 else 1))
                in_channels = width * Bottleneck.expansion
            self.add_module(f"layer{index}", nn.Sequential(*layer))
        for name, param in self.named_parameters():
            param.requires_grad_(name.startswith(self.TRAINED))

    def forward(self, inputs):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(inputs))), 3, stride=2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """torchvision's initialization: every convolution He-normal over its
        fan-out (``kaiming_normal_``, ReLU gain), every norm the identity."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                nn.init.kaiming_normal_(module.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)

    @torch.no_grad()
    def calibrate_(self, inputs, branch_scale: float = RESIDUAL_BRANCH_SCALE):
        """Set every norm's statistics from ``inputs`` (a calibration batch,
        NCHW), in the order the forward reaches them: each norm's running
        mean and variance become its own input's per-channel mean and
        (biased) variance, so that every norm's output has zero mean and
        unit variance on the batch, and the last norm of each residual
        branch (``bn3``) scales its output by ``branch_scale``. Returns the
        C5 map of ``inputs``.

        Why the branch scale: with every norm the identity on its input, a
        random ResNet-50 is chaotic (each block adds a branch as large as
        its shortcut): it amplifies a relative perturbation of its input
        several hundredfold, so one float32 rounding moves C5 by 1e-4 and
        bfloat16 products by 60 %, where an ImageNet-trained trunk, whose
        last norms of the branches carry small scales, does not. At 0.2
        bfloat16 products move C5 by 0.4 % and float32's by 3e-7."""
        last = {id(block.bn3) for block in self.modules() if isinstance(block, Bottleneck)}

        def set_statistics(norm, args):
            x = args[0]
            norm.running_mean.copy_(x.mean(dim=(0, 2, 3)))
            norm.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
            if id(norm) in last:
                norm.weight.fill_(branch_scale)

        hooks = [m.register_forward_pre_hook(set_statistics) for m in self.modules()
                 if isinstance(m, FrozenBatchNorm2d)]
        try:
            return self(inputs)
        finally:
            for hook in hooks:
                hook.remove()
