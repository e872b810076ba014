"""The hypernetwork that generates each instance's residual-field MLP.

Counterpart of ``vsrd_tpu/models/hyper_field.py``: weight-normalised
linear layers with LayerNorm and exact GELU map an instance embedding to
the flattened weights of a small field MLP (48 -> 16 -> 16 -> 16 -> 16 ->
1 at the published widths: 1617 floats per instance). The parameters are
a plain dict so that they convert one to one from the JAX pytree.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def field_layer_sizes(in_channels: int, out_channels_list: Sequence[int],
                      final_channels: int = 1):
    """Per-layer (in, out) and flattened parameter counts of the generated
    MLP; each layer is an ``[out, in + 1]`` block with the bias last."""
    ins = [in_channels, *out_channels_list]
    outs = [*out_channels_list, final_channels]
    num_neurons = [o * (i + 1) for i, o in zip(ins, outs)]
    return list(zip(ins, outs)), num_neurons


def _linear_init(generator, in_channels, out_channels, device):
    """torch nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in)) for both
    weight and bias."""
    bound = 1.0 / math.sqrt(in_channels)
    v = torch.empty(out_channels, in_channels, device=device)
    b = torch.empty(out_channels, device=device)
    v.uniform_(-bound, bound, generator=generator)
    b.uniform_(-bound, bound, generator=generator)
    return v, b


def init_hyper_field(
    generator: torch.Generator,
    in_channels: int = 48,
    out_channels_list: Sequence[int] = (16, 16, 16, 16),
    hyper_in_channels: int = 256,
    hyper_out_channels_list: Sequence[int] = (256, 256, 256, 256),
    final_channels: int = 1,
    device: torch.device | str | None = None,
):
    """Hypernetwork parameters: hidden blocks of [weight-norm Linear ->
    LayerNorm -> GELU] and a final weight-norm Linear emitting the
    flattened field-MLP weights. Weight norm: w = g * v / ||v||_row with g
    initialised to ||v||_row. ``device`` defaults to the generator's."""
    device = generator.device if device is None else device
    _, num_neurons = field_layer_sizes(in_channels, out_channels_list, final_channels)
    hyper_ins = [hyper_in_channels, *hyper_out_channels_list]
    hyper_outs = [*hyper_out_channels_list, sum(num_neurons)]

    layers = []
    for index, (h_in, h_out) in enumerate(zip(hyper_ins, hyper_outs)):
        v, b = _linear_init(generator, h_in, h_out, device)
        layer = {"v": v, "g": torch.linalg.vector_norm(v, dim=-1), "b": b}
        if index < len(hyper_ins) - 1:
            layer["ln_scale"] = torch.ones(h_out, device=device)
            layer["ln_bias"] = torch.zeros(h_out, device=device)
        layers.append(layer)
    return {"layers": layers}


def _weight_norm(v, g):
    norms = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v * (g[..., :, None] / norms)


def layer_norm(x, scale=None, bias=None, epsilon: float = 1e-5):
    """LayerNorm over the last axis with the JAX package's rounding order:
    (x - mean) * rsqrt(biased var + eps), then the optional affine."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def hypernetwork_apply(params, embeddings: torch.Tensor) -> torch.Tensor:
    """Embeddings ``[..., N, E]`` -> flattened field weights ``[..., N, W]``.

    Stacked parameters (a leading frame axis on every leaf, as
    ``optimize.init_params_batched`` makes them) take embeddings ``[F, N,
    E]``: frame f's instances go through frame f's hypernetwork."""
    x = embeddings
    layers = params["layers"]

    def row(t):  # a per-output vector [..., C] -> [..., 1, C], broadcast over N
        return t[..., None, :]

    for layer in layers[:-1]:
        w = _weight_norm(layer["v"], layer["g"])
        x = torch.matmul(x, w.transpose(-2, -1)) + row(layer["b"])
        x = layer_norm(x, row(layer["ln_scale"]), row(layer["ln_bias"]))
        x = F.gelu(x)
    last = layers[-1]
    w = _weight_norm(last["v"], last["g"])
    return torch.matmul(x, w.transpose(-2, -1)) + row(last["b"])
