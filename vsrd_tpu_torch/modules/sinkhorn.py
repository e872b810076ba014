"""Sinkhorn-Knopp optimal transport iteration.

Counterpart of ``vsrd_tpu/modules/sinkhorn.py``: log-domain updates from
u = v = 1, as the JAX package starts them.
"""

from __future__ import annotations

import torch


def sinkhorn_knopp(cost, row_marginals, col_marginals, gamma=0.1, num_steps=50,
                   epsilon=1e-6):
    """Transport plan ``[R, C]`` for cost ``[R, C]`` with marginals ``d [R]``,
    ``s [C]``."""
    d = torch.log(row_marginals + epsilon)
    s = torch.log(col_marginals + epsilon)
    m = -cost / gamma
    u, v = torch.ones_like(d), torch.ones_like(s)
    for _ in range(num_steps):
        u = d - torch.logsumexp(m + v[None, :], dim=1)
        v = s - torch.logsumexp(m + u[:, None], dim=0)
    return torch.exp(u[:, None] + m + v[None, :])
