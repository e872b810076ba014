"""Device-side categorical sampling without replacement (Gumbel top-k).

Counterpart of ``vsrd_tpu/ops/sampling.py`` (``multinomial_logits``,
``log_weights`` and ``multinomial_no_replacement``): adding
Gumbel noise to log weights and taking the k largest draws exactly from
``torch.multinomial(replacement=False)``, with one noise + top-k per step.
The JAX package's bucketed two-phase top-k is a TPU workaround and is not
carried over.
"""

from __future__ import annotations

import torch


def multinomial_logits(
    logits: torch.Tensor,
    num_samples: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``num_samples`` distinct indices drawn with probability
    proportional to ``exp(logits)`` over the last axis."""
    tiny = torch.finfo(logits.dtype).tiny
    uniform = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=logits.dtype,
    ).clamp_(min=tiny)
    gumbel = -torch.log(-torch.log(uniform))
    return torch.topk(logits + gumbel, num_samples, dim=-1).indices


def log_weights(weights: torch.Tensor) -> torch.Tensor:
    """Log weights for ``multinomial_logits``: ``-inf`` where a weight is 0."""
    logits = torch.log(torch.clamp(weights, min=torch.finfo(weights.dtype).tiny))
    return torch.where(weights > 0, logits, -torch.inf)


def multinomial_no_replacement(
    weights: torch.Tensor,
    num_samples: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``num_samples`` distinct indices drawn with probability proportional
    to the nonnegative (not necessarily normalized) ``weights [..., P]``,
    independently per row."""
    return multinomial_logits(log_weights(weights), num_samples, generator)
