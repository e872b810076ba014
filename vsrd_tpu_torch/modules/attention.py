"""Attention modules over feature maps.

Counterpart of ``vsrd_tpu/modules/attention.py``, with its API: feature maps
come in channel-last (``[B, H, W, C]``), as in the JAX package, and go
channel-first inside where torch's ops want them (``F.unfold``,
``F.grid_sample``). The submodules carry the flax auto names (``Dense_0``
... in call order), so that ``utils/convert.py`` maps the two parameter
trees onto each other by path. All three scale the logits by
``1/sqrt(out_channels)``, the whole width and not a head's, as the JAX
modules do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import grid_sample_nchw


def conv_output_size(input_size, kernel_size, stride, padding, dilation):
    return (input_size + padding * 2 - dilation * (kernel_size - 1) - 1) // stride + 1


def _dense_layers(module: nn.Module, in_channels, out_channels, bias):
    """``Dense_0..2`` from the queries', keys' and values' widths to
    ``out_channels``, and ``Dense_3``, the output projection."""
    for index, width in enumerate(in_channels):
        module.add_module(f"Dense_{index}", nn.Linear(width, out_channels, bias=bias))
    module.add_module("Dense_3", nn.Linear(out_channels, out_channels, bias=bias))


class MultiHeadLocalAttention2d(nn.Module):
    """Windowed attention: each query pixel attends to the KxK
    neighbourhood of its key and value maps (NHWC in and out)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, dilation=1,
                 num_heads=1, use_bias=True):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.num_heads = num_heads
        _dense_layers(self, [in_channels] * 3, out_channels, use_bias)

    def forward(self, queries, keys, values):
        k, c, m = self.kernel_size, self.out_channels, self.num_heads
        head = c // m
        pad = self.dilation * (k - 1) // 2

        def patches(x):
            # channel-major patches [B, C*K*K, H'*W'], as conv_general_dilated_patches
            return F.unfold(x.permute(0, 3, 1, 2), k, dilation=self.dilation, padding=pad,
                            stride=self.stride)

        q = self.Dense_0(queries)[:, ::self.stride, ::self.stride]
        b, h, w, _ = q.shape
        kp = patches(self.Dense_1(keys)).reshape(b, m, head, k * k, h, w)
        vp = patches(self.Dense_2(values)).reshape(b, m, head, k * k, h, w)
        q = q.reshape(b, h, w, m, head)
        logits = torch.einsum("bhwmc,bmcshw->bhwms", q, kp) / math.sqrt(c)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhwms,bmcshw->bhwmc", attn, vp).reshape(b, h, w, c)
        return self.Dense_3(out)


class MultiHeadGlobalAttention2d(nn.Module):
    """Full spatial attention of every query pixel over every key pixel
    (NHWC in and out)."""

    def __init__(self, in_channels, out_channels, num_heads=1, use_bias=True):
        super().__init__()
        self.out_channels = out_channels
        self.num_heads = num_heads
        _dense_layers(self, [in_channels] * 3, out_channels, use_bias)

    def forward(self, queries, keys, values):
        c, m = self.out_channels, self.num_heads
        head = c // m
        b, hq, wq, _ = queries.shape
        q = self.Dense_0(queries).reshape(b, hq * wq, m, head)
        k = self.Dense_1(keys).reshape(b, -1, m, head)
        v = self.Dense_2(values).reshape(b, -1, m, head)
        logits = torch.einsum("bqmc,bkmc->bmqk", q, k) / math.sqrt(c)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bmqk,bkmc->bqmc", attn, v).reshape(b, hq, wq, c)
        return self.Dense_3(out)


class MultiHeadDeformableAttention(nn.Module):
    """Query-conditioned sparse sampling attention: each query ``[B, N, C]``
    predicts ``num_samples`` normalized locations in [-1, 1]^2, and its
    keys and values are sampled bilinearly there from the NHWC maps of the
    same width (``align_corners=False``, zero padding)."""

    def __init__(self, in_channels, out_channels, num_samples, num_heads=1, use_bias=True):
        super().__init__()
        self.out_channels = out_channels
        self.num_samples = num_samples
        self.num_heads = num_heads
        # the offset predictor has its own name, so that a parameter group
        # can give it its own learning rate
        self.sampling_offsets = nn.Linear(in_channels, num_samples * 2, bias=use_bias)
        _dense_layers(self, [in_channels] * 3, out_channels, use_bias)

    def forward(self, queries, keys, values):
        c, m, s = self.out_channels, self.num_heads, self.num_samples
        head = c // m
        b, n, _ = queries.shape
        locations = torch.tanh(self.sampling_offsets(queries)).reshape(b, n, s, 2)
        q = self.Dense_0(queries)
        key_maps = self.Dense_1(keys).permute(0, 3, 1, 2)
        val_maps = self.Dense_2(values).permute(0, 3, 1, 2)
        sampled_k = grid_sample_nchw(key_maps, locations).reshape(b, m, head, n, s)
        sampled_v = grid_sample_nchw(val_maps, locations).reshape(b, m, head, n, s)
        q = q.reshape(b, n, m, head)
        logits = torch.einsum("bnmc,bmcns->bnms", q, sampled_k) / math.sqrt(c)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnms,bmcns->bnmc", attn, sampled_v).reshape(b, n, c)
        return self.Dense_3(out)
