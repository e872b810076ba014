"""Positional encoders: NeRF's sinusoidal encoding and TensoRF's CP and VM
factorized grids.

Counterpart of ``vsrd_tpu/models/encoders.py``: pure functions over plain
dicts of tensors. The grids' initial draws come from a ``torch.Generator``;
``convert.to_torch_tree`` carries the JAX package's grids over as they are.
"""

from __future__ import annotations

import math

import torch

VM_AXES = ((0, 1), (0, 2), (1, 2))
VM_COMPLEMENTS = (2, 1, 0)


def sinusoidal_frequencies(num_frequencies: int, dtype=torch.float32,
                           device: torch.device | str | None = None) -> torch.Tensor:
    """2^k pi for k = 0 .. num_frequencies - 1."""
    return (2.0 ** torch.arange(num_frequencies, dtype=dtype, device=device)) * math.pi


def sinusoidal_encode(positions: torch.Tensor, num_frequencies: int = 8) -> torch.Tensor:
    """``[..., D]`` -> ``[..., D * num_frequencies * 2]``, dimension-major,
    then frequency, then (cos, sin)."""
    freqs = sinusoidal_frequencies(num_frequencies, positions.dtype, positions.device)
    phases = positions[..., None] * freqs                                  # [..., D, F]
    enc = torch.stack([torch.cos(phases), torch.sin(phases)], dim=-1)      # [..., D, F, 2]
    return enc.reshape(*positions.shape[:-1], -1)


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device) * 0.1


def init_tensorial_cp_encoder(generator: torch.Generator, num_features: int, grid_size,
                              dtype=torch.float32, device: torch.device | str | None = None):
    """CP factorization: three 1-D factor lines ``[num_features, size_axis]``
    (on ``device``, by default the generator's)."""
    device = generator.device if device is None else device
    return {"lines": [_normal(generator, (num_features, s), dtype, device) for s in grid_size]}


def _line_sample(line: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``line [F, S]`` at coords in [-1, 1] ->
    ``[F, ...]`` (differentiable in both)."""
    size = line.shape[-1]
    x = (coords + 1.0) * 0.5 * (size - 1)
    x0 = torch.clamp(torch.floor(x), 0, size - 2)
    w = x - x0
    i0 = x0.long()
    return line[:, i0] * (1.0 - w) + line[:, i0 + 1] * w


def tensorial_cp_encode(params, positions: torch.Tensor) -> torch.Tensor:
    """``positions [..., 3]`` in [-1, 1] -> ``[..., num_features]``: the
    product of the three lines' features."""
    feats = 1.0
    for axis, line in enumerate(params["lines"]):
        feats = feats * _line_sample(line, positions[..., axis])
    return torch.movedim(feats, 0, -1)


def init_tensorial_vm_encoder(generator: torch.Generator, num_features: int, grid_size,
                              dtype=torch.float32, device: torch.device | str | None = None):
    """VM factorization: three planes ``[F, S_a, S_b]`` over the axis pairs
    (0, 1), (0, 2), (1, 2), each with the line of the third axis."""
    device = generator.device if device is None else device
    planes = [_normal(generator, (num_features, grid_size[a], grid_size[b]), dtype, device)
              for a, b in VM_AXES]
    lines = [_normal(generator, (num_features, grid_size[c]), dtype, device)
             for c in VM_COMPLEMENTS]
    return {"planes": planes, "lines": lines}


def _plane_sample(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``plane [F, Sa, Sb]`` at 2-D coords ``[...,
    2]`` in [-1, 1] -> ``[F, ...]``."""
    _, sa, sb = plane.shape
    a = (coords[..., 0] + 1.0) * 0.5 * (sa - 1)
    b = (coords[..., 1] + 1.0) * 0.5 * (sb - 1)
    a0 = torch.clamp(torch.floor(a), 0, sa - 2)
    b0 = torch.clamp(torch.floor(b), 0, sb - 2)
    wa, wb = a - a0, b - b0
    ia, ib = a0.long(), b0.long()
    top = plane[:, ia, ib] * (1 - wb) + plane[:, ia, ib + 1] * wb
    bottom = plane[:, ia + 1, ib] * (1 - wb) + plane[:, ia + 1, ib + 1] * wb
    return top * (1 - wa) + bottom * wa


def tensorial_vm_encode(params, positions: torch.Tensor) -> torch.Tensor:
    """``positions [..., 3]`` in [-1, 1] -> ``[..., num_features]``: the sum
    of the three plane x line products."""
    feats = 0.0
    for plane, line, (a, b), c in zip(params["planes"], params["lines"], VM_AXES,
                                      VM_COMPLEMENTS):
        plane_feat = _plane_sample(plane, torch.stack([positions[..., a], positions[..., b]],
                                                      dim=-1))
        feats = feats + plane_feat * _line_sample(line, positions[..., c])
    return torch.movedim(feats, 0, -1)
