"""Carry parameters and optimizer state over from the JAX package.

The JAX package keeps the per-frame parameters as a pytree
``{"boxes": {...}, "hyper": {"layers": [{...}, ...]}}`` and its Adam state
as ``{"mu": <params tree>, "nu": <params tree>, "count": int}``. Given as
numpy arrays (``jax.device_get`` of either), these become the port's
nested dicts of tensors with the same keys, so that both packages compute
the same thing from the same state. The tensors go to the card unless
the caller asks for another device (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch_tree(tree, device: torch.device | str = "cuda"):
    """Nested dicts/lists of arrays -> the same structure of f32 tensors
    (integer and bool arrays keep their kind)."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch_tree(v, device) for v in tree]
    array = np.asarray(tree)
    if array.dtype.kind == "f":
        array = array.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(array), device=device)


def params_from_jax(params, device: torch.device | str = "cuda"):
    """The JAX package's params pytree (as numpy) -> the port's params."""
    return {
        "boxes": to_torch_tree(params["boxes"], device),
        "hyper": {"layers": to_torch_tree(list(params["hyper"]["layers"]), device)},
    }


def adam_state_from_jax(state, device: torch.device | str = "cuda"):
    """The JAX package's Adam state ``{"mu", "nu", "count"}`` -> the port's."""
    return {
        "mu": params_from_jax(state["mu"], device),
        "nu": params_from_jax(state["nu"], device),
        "count": int(np.asarray(state["count"])),
    }

