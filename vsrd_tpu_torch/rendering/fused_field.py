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
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..models.hyper_field import field_layer_sizes, layer_norm
from . import sdf as sdf_ops


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


def encode(local: torch.Tensor, position_scale: float, num_frequencies: int):
    """Sinusoidal encoding of the x-mirrored local point ``[..., 3]`` ->
    ``[..., 6 * num_frequencies]`` in (k, cos/sin, dim) order."""
    sym = torch.cat([torch.abs(local[..., :1]), local[..., 1:]], dim=-1)
    sym = sym / position_scale
    # fl(pi) 2^k is fl(pi 2^k): the phases are the per-frequency products
    frequencies = torch.exp2(torch.arange(num_frequencies, dtype=sym.dtype,
                                          device=sym.device)) * math.pi
    phase = sym[..., None, :] * frequencies[:, None]                 # [..., k, dim]
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2).flatten(-3)


def instance_distances(positions, locations, rotations, half_dims, layers,
                       position_scale: float = 100.0, num_frequencies: int = 8):
    """Per-instance signed distances ``[(F,) P, N]`` at points ``[(F,) P,
    3]``, with ``[(F,) N, ...]`` parameters for a leading frame axis.

    ``layers`` is the ``split_field_layers`` tuple, or ``None`` for the
    box-only warmup phase."""
    local = sdf_ops.into_instance_frame(positions, locations, rotations)  # [P, N, 3]
    distances = sdf_ops.box_sdf(local, half_dims[..., None, :, :])        # [P, N]
    if layers is None:
        return distances
    x = encode(local, position_scale, num_frequencies)                     # [P, N, 48]
    for index, w_full in enumerate(layers):
        if index:
            x = F.gelu(layer_norm(x))
        if x.ndim == 3:
            x = torch.einsum("pnc,noc->pno", x, w_full[..., :-1]) + w_full[..., -1]
        else:
            x = (torch.einsum("fpnc,fnoc->fpno", x, w_full[..., :-1])
                 + w_full[..., None, :, :, -1])
    return distances + sdf_ops.residual_squash(x[..., 0])


def scene_eval(positions, locations, rotations, half_dims, valid, layers,
               temperature, position_scale: float = 100.0,
               num_frequencies: int = 8):
    """(union sdf [P], softmin weights [P, N]) at points ``[P, 3]``.

    ``valid [N]`` is float (1.0 real / 0.0 padded)."""
    distances = instance_distances(
        positions, locations, rotations, half_dims, layers,
        position_scale, num_frequencies,
    )
    return sdf_ops.masked_softmin_union(distances, valid, temperature)


def scene_eval_with_grad(positions, locations, rotations, half_dims, valid,
                         weights, temperature, position_scale: float = 100.0):
    """Plain twin of kernels K1 (forward) and K2 (its backward).

    Returns ``(u [P], w [P, N], grad_x u [P, 3])`` for flattened field
    weights ``weights [N, 1617]`` (``None`` = box only). The spatial
    gradient comes from ``autograd.grad(create_graph=True)``, so autograd
    also gives the gradients of all three outputs with respect to the
    box parameters and the weights; positions are constants.
    """
    layers = None if weights is None else split_field_layers(weights)
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        u, w = scene_eval(pos, locations, rotations, half_dims, valid, layers,
                          temperature, position_scale)
        (g,) = torch.autograd.grad(u.sum(), pos, create_graph=keep_graph)
    if not keep_graph:
        u, w = u.detach(), w.detach()
    return u, w, g


def scene_eval_dir(positions, directions, locations, rotations, half_dims,
                   valid, weights, temperature, position_scale: float = 100.0):
    """Plain twin of kernel K3: ``(u [P], w [P, N], <dir, grad_x u> [P])``
    by one forward-mode tangent along ``directions [P, 3]``. Forward only:
    every output is detached from the parameters."""
    layers = None if weights is None else tuple(
        m.detach() for m in split_field_layers(weights)
    )
    args = (locations.detach(), rotations.detach(), half_dims.detach(),
            valid.detach(), layers, torch.as_tensor(temperature).detach(),
            position_scale)

    def field(p):
        return scene_eval(p, *args)

    with torch.no_grad():
        (u, w), (u_dot, _) = torch.func.jvp(
            field, (positions.detach(),), (directions.detach(),)
        )
    return u, w, u_dot


def scene_eval_with_grad_batched(positions, locations, rotations, half_dims, valid,
                                 weights, temperature, position_scale: float = 100.0):
    """Plain twin of kernels K4a (forward) and K4c (its backward):
    ``scene_eval_with_grad`` per frame of positions ``[F, P, 3]`` with
    ``[F, N, ...]`` parameters (``weights [F, N, 1617]`` or ``None``) and
    one temperature, stacked to ``(u [F, P], w [F, P, N], grad_x u [F, P,
    3])``."""
    outs = [
        scene_eval_with_grad(positions[f], locations[f], rotations[f], half_dims[f],
                             valid[f], None if weights is None else weights[f],
                             temperature, position_scale)
        for f in range(positions.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def scene_eval_dir_batched(positions, directions, locations, rotations, half_dims,
                           valid, weights, temperature, position_scale: float = 100.0):
    """Plain twin of kernel K4b: ``scene_eval_dir`` per frame of
    ``[F, P, 3]`` positions and directions, stacked."""
    outs = [
        scene_eval_dir(positions[f], directions[f], locations[f], rotations[f],
                       half_dims[f], valid[f], None if weights is None else weights[f],
                       temperature, position_scale)
        for f in range(positions.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))
