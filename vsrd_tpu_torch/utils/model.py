"""Model parameter utilities: moving averages, frozen parameters, spectral
normalization, and folding or converting normalization layers.

Counterpart of ``vsrd_tpu/utils/model.py``, on the port's nested dicts of
tensors and its optimizer interface (``init(params)``, ``step(params,
grads, state)`` with the state's moments as trees like ``params``, as
``pipeline.optimize.Adam`` keeps them). A path is the tuple of keys and
list indices that ``optimize.tree_leaves`` gives.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..pipeline.optimize import tree_leaves


def _map_pairs(fn, first, second):
    if isinstance(first, dict):
        return {k: _map_pairs(fn, v, second[k]) for k, v in first.items()}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_pairs(fn, a, b) for a, b in zip(first, second))
    return fn(first, second)


def ema_update(ema_params, params, decay: float = 0.999):
    """Exponential moving average of a parameter tree."""
    return _map_pairs(lambda e, p: e * decay + p * (1.0 - decay), ema_params, params)


def average_update(avg_params, params, count):
    """Cumulative average: ``(new average, count + 1)``."""
    return _map_pairs(lambda a, p: a + (p - a) / (count + 1), avg_params, params), count + 1


def freeze_mask(params, predicate: Callable[[tuple, torch.Tensor], bool]):
    """A tree of booleans like ``params``: True where ``predicate(path,
    leaf)`` says the leaf trains."""
    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, path + (i,)) for i, v in enumerate(tree))
        return bool(predicate(path, tree))
    return build(params, ())


class FrozenOptimizer:
    """An optimizer that updates only the leaves its mask marks trainable: a
    frozen leaf gets a zero update and its moments are left as they were,
    as ``optax.masked`` with ``set_to_zero`` leaves them in the JAX package."""

    def __init__(self, optimizer, mask):
        self.optimizer = optimizer
        self.frozen = {path for path, trains in tree_leaves(mask) if not trains}

    def init(self, params):
        return self.optimizer.init(params)

    @torch.no_grad()
    def step(self, params, grads, state):
        moments = {key: dict(tree_leaves(tree)) for key, tree in state.items()
                   if isinstance(tree, (dict, list))}
        saved = [(t, t.clone()) for path, t in tree_leaves(params) if path in self.frozen]
        saved += [(leaves[path], leaves[path].clone()) for leaves in moments.values()
                  for path in self.frozen if path in leaves]
        self.optimizer.step(params, grads, state)
        for tensor, value in saved:
            tensor.copy_(value)


def frozen_optimizer(optimizer, params, predicate):
    """``optimizer`` updating only the leaves where ``predicate`` is True."""
    return FrozenOptimizer(optimizer, freeze_mask(params, predicate))


def spectral_normalize(weight: torch.Tensor, num_iterations: int = 1, epsilon: float = 1e-12):
    """A 2-D weight over its largest singular value, estimated by power
    iteration from u = 1."""
    u = torch.ones(weight.shape[0], dtype=weight.dtype, device=weight.device)
    for _ in range(num_iterations):
        v = weight.T @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=epsilon)
        u = weight @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=epsilon)
    sigma = torch.linalg.vector_norm(weight.T @ u)
    return weight / torch.clamp(sigma, min=epsilon)


def fuse_post_norm(weight: torch.Tensor, bias, norm_scale, norm_bias, running_mean,
                   running_var, epsilon: float = 1e-5):
    """Fold a trailing normalization with tracked statistics into the
    preceding linear or convolution weights ``[O, ...]`` (output channel
    first): ``(fused_weight, fused_bias)`` compute ``norm(layer(x))``."""
    gain = norm_scale * torch.rsqrt(running_var + epsilon)
    fused_weight = weight * gain.reshape((-1,) + (1,) * (weight.ndim - 1))
    if bias is None:
        bias = torch.zeros_like(running_mean)
    return fused_weight, norm_bias + (bias - running_mean) * gain


def batch_norm_to_group_norm_params(bn_params: dict, num_groups=None, group_size=None) -> dict:
    """BatchNorm params ``{'scale', 'bias'}`` (tracked statistics ignored)
    -> GroupNorm params with ``num_groups`` (or channels / ``group_size``)."""
    channels = bn_params["scale"].shape[0]
    if (num_groups is None) == (group_size is None):
        raise ValueError("give exactly one of num_groups and group_size")
    groups = num_groups if num_groups is not None else channels // group_size
    if channels % groups:
        raise ValueError(f"{channels} channels do not split into {groups} groups")
    return {"scale": bn_params["scale"], "bias": bn_params["bias"], "num_groups": groups}


def group_norm_to_batch_norm_params(gn_params: dict) -> dict:
    """GroupNorm params -> BatchNorm params with neutral statistics."""
    scale = gn_params["scale"]
    return {"scale": scale, "bias": gn_params["bias"], "mean": torch.zeros_like(scale),
            "var": torch.ones_like(scale)}

