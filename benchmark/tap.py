"""What the field kernels themselves produced in a checked step.

While ``field_calls`` is open, each call of the port's field entry
``field_kernels.fused_field_with_grad`` that carries the residual field's
weights with a gradient (the fine pass of a residual step) is recorded on
the host: its points, its outputs ``u``, ``w`` and ``g`` (K1/K4a), the
cotangents of those outputs that reach its backward, and the cotangent of
the weights that the backward returns (K2/K4c). The call itself runs as
before; the outputs pass through an identity whose backward reads the
cotangents.
"""

from __future__ import annotations

import contextlib
import inspect

import torch


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class _Cotangents(torch.autograd.Function):
    """``(u, w, g)`` unchanged; the backward keeps their cotangents."""

    @staticmethod
    def forward(ctx, call, u, w, g):
        ctx.call = call
        return u.clone(), w.clone(), g.clone()

    @staticmethod
    def backward(ctx, du, dw, dg):
        ctx.call.update(du=host(du), dw=host(dw), dg=host(dg))
        return None, du, dw, dg


@contextlib.contextmanager
def field_calls(field_kernels):
    """Record the residual field's calls (see the module docstring); yields
    the list that the calls are appended to."""
    entry = field_kernels.fused_field_with_grad
    signature = inspect.signature(entry)
    calls = []

    def tapped(*args, **kwargs):
        arguments = signature.bind(*args, **kwargs).arguments
        weights = arguments.get("weights")
        u, w, g = entry(*args, **kwargs)
        if weights is None or not weights.requires_grad or not torch.is_grad_enabled():
            return u, w, g
        call = {"positions": host(arguments["positions"]), "u": host(u), "w": host(w),
                "g": host(g)}
        weights.register_hook(lambda grad: call.__setitem__("dweights", host(grad)))
        calls.append(call)
        return _Cotangents.apply(call, u, w, g)

    field_kernels.fused_field_with_grad = tapped
    try:
        yield calls
    finally:
        field_kernels.fused_field_with_grad = entry


def per_frame(call: dict, frames: int) -> list:
    """A recorded call as one dict per frame (a leading frame axis for
    ``frames > 1``)."""
    if frames == 1:
        return [call]
    return [{k: v[f] for k, v in call.items()} for f in range(frames)]
