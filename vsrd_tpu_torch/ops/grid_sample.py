"""Bilinear grid sampling with torch's semantics.

Counterpart of ``vsrd_tpu/ops/grid_sample.py``, which writes out
``torch.nn.functional.grid_sample`` (bilinear, ``align_corners``, zero
padding) because JAX has no such op; here it is that op. Coordinates are
normalized to [-1, 1], x then y. The gradient reaches both the image and
the grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(inputs: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """``inputs [C, H, W]``, ``grid [..., 2]`` -> ``[C, ...]`` bilinear
    samples."""
    lead = grid.shape[:-1]
    flat = grid.reshape(1, -1, 1, 2).to(inputs.dtype)
    out = F.grid_sample(inputs[None], flat, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.reshape(inputs.shape[0], *lead)


def grid_sample_nchw(inputs: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Batched form: ``inputs [B, C, H, W]``, ``grid [B, ..., 2]`` -> ``[B,
    C, ...]``."""
    b, c = inputs.shape[:2]
    lead = grid.shape[1:-1]
    flat = grid.reshape(b, -1, 1, 2).to(inputs.dtype)
    out = F.grid_sample(inputs, flat, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.reshape(b, c, *lead)
