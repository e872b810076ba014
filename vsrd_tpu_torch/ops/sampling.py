"""Device-side categorical sampling without replacement (Gumbel top-k).

Counterpart of ``vsrd_tpu/ops/sampling.py::multinomial_logits``: adding
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
