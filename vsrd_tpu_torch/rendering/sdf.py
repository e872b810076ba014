"""Box signed distance, the masked softmin union and the residual squash.

Counterpart of ``vsrd_tpu/rendering/sdf.py``, written the way the JAX
kernel bodies write them (``fused_field._instance_distance`` and
``scene_eval``), because these functions are the plain twins of the CUDA
kernels in ``csrc/``:

* the box SDF picks its max face with explicit selects, so autograd
  takes the same branch at a tie as the hand-written kernels;
* the union masks padded instances with an additive ``(valid - 1) *
  1e30`` on the f32 logits rather than ``-inf``, so a frame with no valid
  instance gives uniform weights instead of NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sdf(local: torch.Tensor, half_dimensions: torch.Tensor) -> torch.Tensor:
    """Axis-aligned box SDF of local points ``[..., 3]`` -> ``[...]``.

    outside = sqrt(|relu(q)|^2 + 1e-6), inside = relu(-max(q)), q = |x| - h.
    """
    q = torch.abs(local) - half_dimensions
    outside = torch.sqrt(torch.sum(torch.square(F.relu(q)), dim=-1) + 1e-6)
    q0, q1, q2 = q.unbind(-1)
    m01 = torch.where(q0 > q1, q0, q1)
    q_max = torch.where(q2 > m01, q2, m01)
    return outside - F.relu(-q_max)


def into_instance_frame(positions, locations, rotations):
    """World points ``[(F,) P, 3]`` -> local frames ``[(F,) P, N, 3]``: (p -
    t) @ R, written as the kernels' three multiply-adds; an optional
    leading frame axis on the points and the ``[(F,) N, ...]`` parameters."""
    rel = positions[..., :, None, :] - locations[..., None, :, :]   # [(F,) P, N, 3]
    rot = rotations[..., None, :, :, :]                             # [(F,) 1, N, 3, 3]
    return (
        rel[..., 0:1] * rot[..., 0, :]
        + rel[..., 1:2] * rot[..., 1, :]
        + rel[..., 2:3] * rot[..., 2, :]
    )


def masked_softmin_union(distances, valid, temperature):
    """Softmin union over the last (instance) axis of ``distances [..., N]``.

    ``valid [N]`` is float (1.0 real, 0.0 padded). Returns
    ``(union [...], weights [..., N])``.
    """
    logits = -distances / temperature + (valid - 1.0) * 1e30
    weights = torch.softmax(logits, dim=-1)
    return torch.sum(distances * weights, dim=-1), weights


def masked_hard_union(distances, valid):
    """Argmin union over the last (instance) axis of ``distances [..., N]``.

    Padded instances (``valid`` bool or 0/1 float ``[..., N]``) read
    ``finfo(f32).max``, ties go to the lowest index, as ``argmin`` does, and
    the weights are one-hot, so that features gather as with the soft union.
    A point with no valid instance gets ``finfo.max`` (no NaN): the masked
    entries times their zero weights add 0. Returns ``(union [...], weights
    [..., N])``.
    """
    big = torch.finfo(distances.dtype).max
    masked = torch.where(valid.bool(), distances, big)
    index = torch.argmin(masked, dim=-1, keepdim=True)
    weights = torch.zeros_like(masked).scatter_(-1, index, 1.0)
    return torch.sum(masked * weights, dim=-1), weights


def residual_squash(raw: torch.Tensor) -> torch.Tensor:
    """Residual-field output squashing: sigmoid(x - 1)."""
    return torch.sigmoid(raw - 1.0)
