"""Carry parameters and optimizer state between the JAX package and the port.

The JAX package keeps the per-frame parameters as a pytree
``{"boxes": {...}, "hyper": {"layers": [{...}, ...]}}`` and its Adam state
as ``{"mu": <params tree>, "nu": <params tree>, "count": int32}``. Given as
numpy arrays (``jax.device_get`` of either, or a checkpoint's entries),
these become the port's nested dicts of tensors with the same keys, so that
both packages compute the same thing from the same state. The tensors go to
the card unless the caller asks for another device (``device="cpu"``).

``params_to_jax`` and ``adam_state_to_jax`` go the other way: the port's
trees become the JAX package's numpy trees, which is what the port's
checkpoints hold.
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



def to_numpy_tree(tree):
    """Nested dicts/lists/tuples of tensors, arrays or scalars -> the same
    structure of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def params_to_jax(params):
    """The port's params -> the JAX package's params pytree, as numpy."""
    return {
        "boxes": to_numpy_tree(params["boxes"]),
        "hyper": {"layers": to_numpy_tree(list(params["hyper"]["layers"]))},
    }


def adam_state_to_jax(state):
    """The port's Adam state -> the JAX package's ``{"mu", "nu", "count"}``
    (``count`` an int32 scalar), as numpy."""
    return {
        "mu": params_to_jax(state["mu"]),
        "nu": params_to_jax(state["nu"]),
        "count": np.asarray(int(state["count"]), np.int32),
    }


# ---------------------------------------------------------------------------
# the detector: a flax parameter tree <-> the port's state_dict
# ---------------------------------------------------------------------------

_MHA = "MultiHeadDotProductAttention"


def _flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat_paths(value, prefix + (str(key),))
    else:
        yield prefix, np.asarray(tree)


def detector_params_from_jax(flax_params, device: torch.device | str = "cuda"):
    """A flax ``DETR3D``/``DeformableDETR3D`` parameter tree as numpy (with
    or without its top-level ``"params"``) -> the port's ``state_dict``:
    ``Conv`` kernels HWIO -> OIHW, ``Dense`` kernels ``[in, out]`` ->
    ``[out, in]``, attention kernels ``[in, heads, head_dim]`` (query, key,
    value) and ``[heads, head_dim, out]`` (out) -> ``Linear`` weights with
    the heads flattened, norm scales -> ``weight``; names keep their paths."""
    tree = flax_params.get("params", flax_params)
    state = {}
    for path, leaf in _flat_paths(tree):
        *module, name = path
        leaf = leaf.astype(np.float32)
        if name == "kernel":
            if leaf.ndim == 4:
                leaf = leaf.transpose(3, 2, 0, 1)
            elif leaf.ndim == 3 and module[-1] == "out":
                leaf = leaf.reshape(-1, leaf.shape[-1]).T
            elif leaf.ndim == 3:
                leaf = leaf.reshape(leaf.shape[0], -1).T
            else:
                leaf = leaf.T
            name = "weight"
        elif name == "bias":
            leaf = leaf.reshape(-1)
        elif name == "scale":
            name = "weight"
        state[".".join([*module, name])] = torch.as_tensor(np.ascontiguousarray(leaf),
                                                           device=device)
    return state


def detector_params_to_jax(state_dict, num_heads: int):
    """The port's detector ``state_dict`` -> the flax parameter tree
    ``{"params": {...}}`` as numpy, the inverse of
    ``detector_params_from_jax`` (``num_heads`` splits the attention
    kernels). The port's detector checkpoints hold this tree."""
    params = {}
    for key, tensor in state_dict.items():
        *module, name = key.split(".")
        leaf = tensor.detach().cpu().numpy()
        attention = len(module) >= 2 and module[-2].startswith(_MHA)
        if name == "weight" and leaf.ndim == 4:
            leaf, name = leaf.transpose(2, 3, 1, 0), "kernel"
        elif name == "weight" and leaf.ndim == 2 and attention and module[-1] == "out":
            leaf, name = leaf.T.reshape(num_heads, -1, leaf.shape[0]), "kernel"
        elif name == "weight" and leaf.ndim == 2 and attention:
            leaf, name = leaf.T.reshape(leaf.shape[1], num_heads, -1), "kernel"
        elif name == "weight" and leaf.ndim == 2:
            leaf, name = leaf.T, "kernel"
        elif name == "weight":
            name = "scale"
        elif name == "bias" and attention and module[-1] != "out":
            leaf = leaf.reshape(num_heads, -1)
        node = params
        for part in module:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(leaf)
    return {"params": params}


def _block_tensor(name: str, array: np.ndarray) -> tuple[str, torch.Tensor]:
    """One flax block parameter -> (the port module's name, its tensor)."""
    if name == "kernel" and array.ndim == 5:
        # flax [kH, kW, kC, 1, D] over (H, W, C) -> torch [D, 1, kC, kH, kW] over (C, H, W)
        return "weight", torch.from_numpy(array.transpose(4, 3, 2, 0, 1).copy())
    if name == "kernel" and array.ndim == 4:
        return "weight", torch.from_numpy(array.transpose(3, 2, 0, 1).copy())   # [O, I, kh, kw]
    if name == "kernel":
        return "weight", torch.from_numpy(array.T.copy())                      # [O, I]
    if name == "scale":
        return "weight", torch.from_numpy(array.copy())
    return name, torch.from_numpy(np.asarray(array).copy())


def blocks_params_from_jax(variables, device: torch.device | str = "cuda"):
    """A flax block's variables (``{"params": {...}}`` or the params, as
    numpy) -> a ``state_dict`` for the port's block of the same kind
    (``modules/blocks.py``): ``Conv_*`` becomes ``conv3d`` or ``conv2d`` by
    its kernel's rank, ``Dense_k`` ``fc{k+1}``, ``GroupNorm_0`` ``norm``."""
    params = variables.get("params", variables)
    state = {}
    for module, value in params.items():
        if not isinstance(value, dict):
            state[module] = torch.as_tensor(np.asarray(value, np.float32))
            continue
        kernel = value.get("kernel")
        if module.startswith("Conv_"):
            target = "conv3d" if np.ndim(kernel) == 5 else "conv2d"
        elif module.startswith("Dense_"):
            target = f"fc{int(module.split('_')[1]) + 1}"
        elif module.startswith("GroupNorm_"):
            target = "norm"
        else:
            raise ValueError(f"no port counterpart for flax module {module!r}")
        for name, array in value.items():
            key, tensor = _block_tensor(name, np.asarray(array, np.float32))
            state[f"{target}.{key}"] = tensor
    return {k: v.to(device) for k, v in state.items()}
