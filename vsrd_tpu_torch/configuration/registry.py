"""Safe constructor registry for config-driven instantiation.

Counterpart of ``vsrd_tpu/configuration/registry.py``: the same JSON shape,
``{"function": name, "args": [...], "kwargs": {...}}`` resolved
recursively, with ``ref:<dotted.path>`` lookups into a context dict and no
``eval:``. The dotted names are the ones the shipped configs and the JAX
package use (``"vsrd_tpu.data.KITTI360Dataset"`` in
``configs/kitti_360/vsrd/config.json``); they are strings in a config, not
imports, and here they resolve to the port's own classes.
"""

from __future__ import annotations

from typing import Any, Callable

REGISTRY: dict[str, Callable] = {}


def register(name: str | None = None):
    """Decorator/function to register a constructor under a dotted name
    (its qualified name by default)."""

    def wrap(fn, name=name):
        REGISTRY[name or fn.__qualname__] = fn
        return fn

    if callable(name):                  # bare @register: the key is the qualified name
        return wrap(name, None)
    return wrap


def register_defaults() -> None:
    """Register the port's public constructors under the JAX package's names
    (and the original VSRD's ``vsrd.*`` names)."""
    from ..data import kitti360
    from ..data import transforms as tf
    from ..pipeline.optimize import OptimizationConfig

    defaults = {}
    for prefix in ("vsrd.datasets", "vsrd_tpu.data"):
        defaults[f"{prefix}.KITTI360Dataset"] = kitti360.KITTI360Dataset
        defaults[f"{prefix}.KITTIRawDataset"] = kitti360.KITTIRawDataset
    for name in ("Resizer", "MaskAreaFilter", "MaskRefiner", "BoxGenerator",
                 "BoxSizeFilter", "SoftRasterizer", "Cropper", "RandomHorizontalFlipper",
                 "BoxJitter", "FractalBrownianMotion", "FastFractalBrownianMotion",
                 "RandomConvolution", "ColorJitter"):
        defaults[f"vsrd.transforms.{name}"] = getattr(tf, name)
    defaults["vsrd_tpu.OptimizationConfig"] = OptimizationConfig
    for name, fn in defaults.items():
        REGISTRY.setdefault(name, fn)


def _lookup(path: str, context: dict) -> Any:
    node: Any = context
    for part in path.split("."):
        node = node[part] if isinstance(node, dict) else getattr(node, part)
    return node


def instantiate(config: Any, context: dict | None = None) -> Any:
    """Recursively resolve a config value.

    * ``{"function": name, "args": [...], "kwargs": {...}}`` -> call the
      registered constructor with resolved args/kwargs;
    * ``"ref:a.b.c"`` -> lookup in ``context``;
    * dicts/lists resolve elementwise; everything else passes through.
    """
    context = context or {}
    if isinstance(config, str):
        if config.startswith("ref:"):
            return _lookup(config[4:], context)
        if config.startswith("eval:"):
            raise ValueError(
                f"eval: expressions are not supported (use ref:<path>); got {config!r}")
        return config
    if isinstance(config, list):
        return [instantiate(item, context) for item in config]
    if isinstance(config, dict):
        if "function" in config:
            name = config["function"]
            if name not in REGISTRY:
                register_defaults()
            if name not in REGISTRY:
                raise KeyError(f"constructor {name!r} is not registered in the port; known: "
                               f"{sorted(REGISTRY)}")
            args = instantiate(config.get("args", []), context)
            kwargs = instantiate(config.get("kwargs", {}), context)
            return REGISTRY[name](*args, **kwargs)
        return {k: instantiate(v, context) for k, v in config.items()}
    return config
