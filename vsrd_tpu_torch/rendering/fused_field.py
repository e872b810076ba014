"""The eager multi-instance scene field: the plain twin of the CUDA kernels.

Counterpart of the math in ``vsrd_tpu/rendering/fused_field.py``
(``split_field_layers``, ``_instance_distance`` and ``scene_eval``), in
plain PyTorch over a padded instance axis. Per point and instance:

    local = R^T (x - loc)                      instance frame
    d     = box_sdf(local, half)               (+ in the residual phase:)
    enc   = [cos, sin](pi 2^k (|l0|, l1, l2) / scale),  k < 8   -> 48 ch
    h     = Linear(48 -> 16), then 4 x [LayerNorm + GELU, Linear] -> 1
    d    += sigmoid(h - 1)

and the union over instances is ``w = softmax(-d/tau + (valid-1)*1e30)``,
``u = sum_i w_i d_i``.

The field-with-gradient and directional-derivative functions at the end
are the plain versions of kernels K1/K2 and K3
(``rendering/field_kernels.py``): autograd gives the spatial gradient
(and, for K2, the backward), ``torch.func.jvp`` the directional one. Their
``_batched`` forms, a loop over a leading frame axis, are the plain
versions of the frame-batched launches K4a/K4c and K4b.

Precision (``precision``, the JAX package's ``pallas_matmul_precision``):
``"highest"`` computes every layer product in f32; ``"default"`` computes
what the TPU's MXU computes at ``Precision.DEFAULT``: each product's two
operands rounded to bf16 (to nearest, ties to even; ``bf16_round``), the
products exact and the sums in the operands' dtype. The bias is a column of
the product times an exact 1, so it is rounded too, as is the 16 -> 1 last
layer; the encoding is the JAX package's fast one (``encode`` with
``fast=True``: exact sin/cos at k = 0 and 4, angle doubling between, and the
rounded 1 / scale). ``bf16_matmul`` carries the rounding through autograd
and ``torch.func.jvp``: its backward rounds the incoming cotangent and the
saved operands (never the result) and is itself differentiable, so the
twin of K2, which differentiates through K1's gradient, rounds every
product as the JAX backward does; its forward-mode rule rounds the tangent
(the JAX kernels stack it beside the value). ``scene.py`` and the sphere
tracer keep the strict default.

Per-tile instance-group skipping (``group_tile_mask``; the JAX package's
``group_skip`` mode, ``fused_field.py:110-200``): instances go in groups of
8 (``group_size_of``; the last group may be partial, since the port does not
pad N to a multiple of 8) and points in tiles of ``mask_tile``; a keep mask
``[(F,) G, T]`` says which groups each tile evaluates. Every twin takes it as
``group_mask`` with its ``mask_tile``: at a point whose tile drops a group,
that group's instances read the distance ``SKIP_DISTANCE`` with a zero
tangent (``torch.where``, so autograd gives them exactly zero cotangents),
and their softmin weights underflow to exactly 0.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..models.hyper_field import field_layer_sizes, layer_norm
from . import sdf as sdf_ops


# Distance of an instance in a dropped group: exp(-d / tau) underflows to
# exactly 0.0 in f32 for every annealed tau, and d / tau stays finite.
SKIP_DISTANCE = 1.0e4
GROUP_SIZE = 8
# the keep slack margin + tau_scale * tau (FieldStatics' group_skip_margin
# and group_skip_tau_scale)
GROUP_SKIP_MARGIN = 2.0
GROUP_SKIP_TAU_SCALE = 12.0
# each instance's residual sigmoid(raw - 1) lies in (0, 1)
_RESIDUAL_BOUND = 1.0
PRECISIONS = ("default", "highest")


def check_precision(precision: str) -> bool:
    """Whether ``precision`` is the default (bf16-operand) mode; raises on
    anything but "default" and "highest"."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, not {precision!r}")
    return precision == "default"


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 value (ties to even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _BF16Matmul(torch.autograd.Function):
    """``bf16_round(a) @ bf16_round(b)``, summed in the operands' dtype."""

    @staticmethod
    def forward(a, b):
        return bf16_round(a) @ bf16_round(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = bf16_matmul(grad, b.mT) if ctx.needs_input_grad[0] else None
        gb = bf16_matmul(a.mT, grad) if ctx.needs_input_grad[1] else None
        return ga, gb

    @staticmethod
    def jvp(ctx, ta, tb):
        a, b = ctx.saved_tensors
        out = None
        if ta is not None:
            out = bf16_round(ta) @ bf16_round(b)
        if tb is not None:
            extra = bf16_round(a) @ bf16_round(tb)
            out = extra if out is None else out + extra
        return out


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A matrix product at the default precision (see the module docstring)."""
    return _BF16Matmul.apply(a, b)


def group_size_of(num_instances: int) -> int:
    """Instances per skip group: the whole scene up to 8, groups of 8 beyond."""
    return num_instances if num_instances <= GROUP_SIZE else GROUP_SIZE


def num_groups_of(num_instances: int) -> int:
    """Skip groups of ``num_instances``; the last one may be partial."""
    return -(-num_instances // group_size_of(num_instances))


def group_skip_threshold(temperature):
    """The relative keep slack A(tau) = margin + tau_scale * tau: a group is
    dropped from a tile when its lower-bound distance exceeds the upper
    bound of the union's log-partition by more than A at every point of the
    tile, so its dropped softmin weights are O(e^-tau_scale)."""
    return GROUP_SKIP_MARGIN + GROUP_SKIP_TAU_SCALE * temperature


@torch.no_grad()
def group_tile_mask(positions, locations, half_dims, valid, threshold, tile: int):
    """Per-(group, tile) keep mask ``[(F,) G, ceil(P / tile)]`` int32.

    ``positions [(F,) P, 3]``, ``locations``/``half_dims [(F,) N, 3]``,
    ``valid [(F,) N]`` (bool or 0/1 float), ``threshold`` a scalar (tensor).
    A group is kept at a tile iff for some point of the tile the distance to
    some valid member's circumscribed sphere comes within ``threshold`` of
    the smallest centre distance + 1 over valid instances (a bound on the
    softmin log-partition); each tile's nearest group (the first, on a tie)
    is always kept. Points past P never force a keep; a frame with no valid
    instance keeps every group (big - big = 0). With N padded by invalid
    slots to a multiple of 8 this is the JAX package's mask."""
    p, n = positions.shape[-2], locations.shape[-2]
    g_size = group_size_of(n)
    groups, tiles = num_groups_of(n), -(-p // tile)
    lead = positions.shape[:-2]
    big = 1e9
    d = torch.linalg.vector_norm(positions[..., :, None, :] - locations[..., None, :, :],
                                 dim=-1)                                     # [..., P, N]
    valid_row = (valid > 0.5)[..., None, :]
    radius = torch.linalg.vector_norm(half_dims, dim=-1)[..., None, :]
    lower = torch.where(valid_row, d - radius, big)
    upper = torch.where(valid_row, d + _RESIDUAL_BOUND, big)
    ub_min = upper.amin(-1, keepdim=True)                                    # [..., P, 1]
    rel = lower - ub_min
    if groups * g_size > n:
        # the JAX package's invalid padding slots: lower = big
        rel = torch.cat([rel, (big - ub_min).expand(*lead, p, groups * g_size - n)], -1)
    rel_g = rel.reshape(*lead, p, groups, g_size).amin(-1)                   # [..., P, G]
    if tiles * tile > p:
        rel_g = torch.cat([rel_g, rel_g.new_full((*lead, tiles * tile - p, groups), big)], -2)
    tile_min = rel_g.reshape(*lead, tiles, tile, groups).amin(-2)            # [..., T, G]
    keep = tile_min <= threshold
    nearest = torch.argmin(tile_min, dim=-1, keepdim=True)
    keep = keep | (torch.arange(groups, device=keep.device) == nearest)
    return keep.transpose(-1, -2).to(torch.int32)


def point_keep(group_mask, num_points: int, num_instances: int, tile: int):
    """``group_mask [(F,) G, T]`` -> ``[(F,) P, N]`` bool: whether point p's
    tile keeps instance i's group."""
    device = group_mask.device
    group = torch.arange(num_instances, device=device) // group_size_of(num_instances)
    tile_of = torch.arange(num_points, device=device) // tile
    return (group_mask != 0)[..., group, :][..., tile_of].transpose(-1, -2)


def enc_permutation(num_frequencies: int = 8, num_dims: int = 3):
    """Map the field's (k, cos/sin, dim)-ordered encoding channels to the
    reference's (dim, k, cos/sin) channels: ``perm[c_field] = c_ref``."""
    perm = []
    for k in range(num_frequencies):
        for cs in range(2):
            for dim in range(num_dims):
                perm.append(dim * 2 * num_frequencies + k * 2 + cs)
    return perm


def split_field_layers(weights: torch.Tensor,
                       in_channels: int = 48,
                       out_channels_list: Sequence[int] = (16, 16, 16, 16),
                       final_channels: int = 1):
    """Flattened per-instance weights ``[(F,) N, W]`` -> per-layer
    ``[(F,) N, out, in + 1]`` tensors, with layer 0's input channels permuted
    into the (k, cos/sin, dim) order that ``encode`` produces."""
    sizes, num_neurons = field_layer_sizes(in_channels, out_channels_list, final_channels)
    lead = weights.shape[:-1]
    perm = torch.tensor(
        [*enc_permutation(in_channels // 6), in_channels], device=weights.device
    )
    layers = []
    offset = 0
    for index, ((c_in, c_out), count) in enumerate(zip(sizes, num_neurons)):
        w = weights[..., offset : offset + count].reshape(*lead, c_out, c_in + 1)
        if index == 0:
            w = w[..., perm]
        layers.append(w)
        offset += count
    return tuple(layers)


def encode(local: torch.Tensor, position_scale: float, num_frequencies: int,
           fast: bool = False):
    """Sinusoidal encoding of the x-mirrored local point ``[..., 3]`` ->
    ``[..., 6 * num_frequencies]`` in (k, cos/sin, dim) order.

    ``fast``: the JAX package's fast encoding (``_encoding_trig``), the one
    its default precision uses: the coordinates times the rounded 1 /
    scale, exact cos and sin at every k % 4 == 0, the others by the
    double-angle recurrence c' = 2 c c - 1, s' = 2 s c."""
    sym = torch.cat([torch.abs(local[..., :1]), local[..., 1:]], dim=-1)
    if fast:
        sym = sym * (1.0 / position_scale)
        pairs = []
        for k in range(num_frequencies):
            if k % 4 == 0:
                phase = sym * (math.pi * 2.0 ** k)
                c, s = torch.cos(phase), torch.sin(phase)
            else:
                c, s = 2.0 * c * c - 1.0, 2.0 * s * c
            pairs.append(torch.stack([c, s], dim=-2))                   # [..., 2, dim]
        return torch.stack(pairs, dim=-3).flatten(-3)
    sym = sym / position_scale
    # fl(pi) 2^k is fl(pi 2^k): the phases are the per-frequency products
    frequencies = torch.exp2(torch.arange(num_frequencies, dtype=sym.dtype,
                                          device=sym.device)) * math.pi
    phase = sym[..., None, :] * frequencies[:, None]                 # [..., k, dim]
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2).flatten(-3)


def instance_distances(positions, locations, rotations, half_dims, layers,
                       position_scale: float = 100.0, num_frequencies: int = 8,
                       precision: str = "highest"):
    """Per-instance signed distances ``[(F,) P, N]`` at points ``[(F,) P,
    3]``, with ``[(F,) N, ...]`` parameters for a leading frame axis.

    ``layers`` is the ``split_field_layers`` tuple, or ``None`` for the
    box-only warmup phase. ``precision``: see the module docstring."""
    bf16 = check_precision(precision)
    local = sdf_ops.into_instance_frame(positions, locations, rotations)  # [P, N, 3]
    distances = sdf_ops.box_sdf(local, half_dims[..., None, :, :])        # [P, N]
    if layers is None:
        return distances
    x = encode(local, position_scale, num_frequencies, fast=bf16)          # [P, N, 48]
    for index, w_full in enumerate(layers):
        if index:
            x = F.gelu(layer_norm(x))
        if bf16:
            # [.., P, N, C + 1] with the bias input 1, as [.., N, P, C + 1]
            # products with [.., N, C + 1, out]
            x_h = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
            x = bf16_matmul(x_h.transpose(-2, -3), w_full.mT).transpose(-2, -3)
        elif x.ndim == 3:
            x = torch.einsum("pnc,noc->pno", x, w_full[..., :-1]) + w_full[..., -1]
        else:
            x = (torch.einsum("fpnc,fnoc->fpno", x, w_full[..., :-1])
                 + w_full[..., None, :, :, -1])
    return distances + sdf_ops.residual_squash(x[..., 0])


def scene_eval(positions, locations, rotations, half_dims, valid, layers,
               temperature, position_scale: float = 100.0,
               num_frequencies: int = 8, group_mask=None, mask_tile: int | None = None,
               precision: str = "highest"):
    """(union sdf [P], softmin weights [P, N]) at points ``[P, 3]``.

    ``valid [N]`` is float (1.0 real / 0.0 padded). With ``group_mask [G,
    T]`` (tiles of ``mask_tile`` points) a dropped group's instances read
    ``SKIP_DISTANCE`` at the tile's points."""
    distances = instance_distances(
        positions, locations, rotations, half_dims, layers,
        position_scale, num_frequencies, precision,
    )
    if group_mask is not None:
        keep = point_keep(group_mask, positions.shape[-2], locations.shape[-2], mask_tile)
        distances = torch.where(keep, distances, SKIP_DISTANCE)
    return sdf_ops.masked_softmin_union(distances, valid, temperature)


def scene_eval_with_grad(positions, locations, rotations, half_dims, valid,
                         weights, temperature, position_scale: float = 100.0,
                         group_mask=None, mask_tile: int | None = None,
                         precision: str = "highest"):
    """Plain twin of kernels K1 (forward) and K2 (its backward).

    Returns ``(u [P], w [P, N], grad_x u [P, 3])`` for flattened field
    weights ``weights [N, 1617]`` (``None`` = box only). The spatial
    gradient comes from ``autograd.grad(create_graph=True)``, so autograd
    also gives the gradients of all three outputs with respect to the
    box parameters and the weights; positions are constants.

    ``group_mask [G, T]`` with ``mask_tile``: the skip mode (see the
    module docstring). The JAX package computes the skip mode's gradient by
    three forward tangents (``rev_grad`` is off there with a mask); the
    port keeps its one reverse-sweep form, the same function.

    ``precision``: see the module docstring. At "default" the gradient's
    reverse sweep rounds the union's cotangents where they enter each
    product, as the JAX kernel's sweep seeded with them does.
    """
    layers = None if weights is None else split_field_layers(weights)
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        u, w = scene_eval(pos, locations, rotations, half_dims, valid, layers,
                          temperature, position_scale, group_mask=group_mask,
                          mask_tile=mask_tile, precision=precision)
        (g,) = torch.autograd.grad(u.sum(), pos, create_graph=keep_graph)
    if not keep_graph:
        u, w = u.detach(), w.detach()
    return u, w, g


def scene_eval_dir(positions, directions, locations, rotations, half_dims,
                   valid, weights, temperature, position_scale: float = 100.0,
                   group_mask=None, mask_tile: int | None = None,
                   precision: str = "highest"):
    """Plain twin of kernel K3: ``(u [P], w [P, N], <dir, grad_x u> [P])``
    by one forward-mode tangent along ``directions [P, 3]``. Forward only:
    every output is detached from the parameters. ``group_mask``: the skip
    mode, as in ``scene_eval_with_grad``; ``precision``: see the module
    docstring (at "default" the tangent is rounded where it enters each
    product)."""
    layers = None if weights is None else tuple(
        m.detach() for m in split_field_layers(weights)
    )
    args = (locations.detach(), rotations.detach(), half_dims.detach(),
            valid.detach(), layers, torch.as_tensor(temperature).detach(),
            position_scale)

    def field(p):
        return scene_eval(p, *args, group_mask=group_mask, mask_tile=mask_tile,
                          precision=precision)

    with torch.no_grad():
        (u, w), (u_dot, _) = torch.func.jvp(
            field, (positions.detach(),), (directions.detach(),)
        )
    return u, w, u_dot


def scene_eval_with_grad_batched(positions, locations, rotations, half_dims, valid,
                                 weights, temperature, position_scale: float = 100.0,
                                 group_mask=None, mask_tile: int | None = None,
                                 precision: str = "highest"):
    """Plain twin of kernels K4a (forward) and K4c (its backward):
    ``scene_eval_with_grad`` per frame of positions ``[F, P, 3]`` with
    ``[F, N, ...]`` parameters (``weights [F, N, 1617]`` or ``None``), one
    temperature and per-frame masks ``group_mask [F, G, T]``, stacked to
    ``(u [F, P], w [F, P, N], grad_x u [F, P, 3])``."""
    outs = [
        scene_eval_with_grad(positions[f], locations[f], rotations[f], half_dims[f],
                             valid[f], None if weights is None else weights[f],
                             temperature, position_scale,
                             None if group_mask is None else group_mask[f], mask_tile,
                             precision)
        for f in range(positions.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def scene_eval_dir_batched(positions, directions, locations, rotations, half_dims,
                           valid, weights, temperature, position_scale: float = 100.0,
                           group_mask=None, mask_tile: int | None = None,
                           precision: str = "highest"):
    """Plain twin of kernel K4b: ``scene_eval_dir`` per frame of
    ``[F, P, 3]`` positions and directions (and ``[F, G, T]`` masks),
    stacked."""
    outs = [
        scene_eval_dir(positions[f], directions[f], locations[f], rotations[f],
                       half_dims[f], valid[f], None if weights is None else weights[f],
                       temperature, position_scale,
                       None if group_mask is None else group_mask[f], mask_tile, precision)
        for f in range(positions.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))
