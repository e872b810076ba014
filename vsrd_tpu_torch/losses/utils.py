"""Loss reduction decorator.

Counterpart of ``vsrd_tpu/losses/utils.py``.
"""

from __future__ import annotations

import functools

import torch


def reduced(loss_function):
    """Adds a ``reduction={'none','mean','sum'}`` keyword to a loss."""

    @functools.wraps(loss_function)
    def wrapper(*args, reduction="mean", **kwargs):
        losses = loss_function(*args, **kwargs)
        if reduction == "none":
            return losses
        if reduction == "mean":
            return torch.mean(losses)
        if reduction == "sum":
            return torch.sum(losses)
        raise ValueError(f"`reduction` should be 'none'|'mean'|'sum', got {reduction}.")

    return wrapper
