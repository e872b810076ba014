"""Bipartite matching that stays on the device.

Counterpart of ``vsrd_tpu/ops/matching.py``. The reference calls
``scipy.optimize.linear_sum_assignment`` on the host every step, which
forces a device-to-host copy per step; the subset DP below runs as a
handful of tensor ops on whatever device the cost lives on.
"""

from __future__ import annotations

import torch

# Uniform cost for any pair touching a padded instance: real costs are
# O(1) (negated DIoU), so mixed valid/pad matches are strictly worse than
# valid/valid + pad/pad.
PAD_COST = 1e6


def linear_sum_assignment_dp(cost: torch.Tensor) -> torch.Tensor:
    """Exact minimum-cost assignment by subset DP, ``[..., n, n] ->
    row_to_col [..., n]``, each leading index (e.g. a frame) on its own.

    ``f[S]`` after row i is the least cost of assigning rows ``0..i`` to
    the column subset ``S``. O(n * 2^n) work, no data-dependent control
    flow and no host synchronisation; leading axes ride along in the same
    ops, so a batch of frames costs no more launches than one frame.
    """
    n = cost.shape[-1]
    lead = cost.shape[:-2]
    device = cost.device
    num_states = 1 << n
    states = torch.arange(num_states, device=device)
    bits = 1 << torch.arange(n, device=device)
    has = (states[None, :] & bits[:, None]) != 0         # [n, 2^n]: c in S
    without = states[None, :] & ~bits[:, None]           # [n, 2^n]: S \ {c}
    inf = torch.tensor(float("inf"), device=device)
    cost = cost.to(torch.float32)

    f = torch.full((*lead, num_states), float("inf"), device=device)
    f[..., 0] = 0.0
    choices = []
    for row in range(n):
        # candidate[c][S] = f[S \ {c}] + cost[row, c], valid iff c in S
        candidate = torch.where(has, f[..., without] + cost[..., row, :, None], inf)
        f, best_col = torch.min(candidate, dim=-2)
        choices.append(best_col)
    choices = torch.stack(choices, dim=-2)               # [..., n, 2^n]

    # backtrack from the full set
    state = torch.full((*lead, 1), num_states - 1, device=device)
    cols = []
    for row in range(n - 1, -1, -1):
        col = torch.gather(choices[..., row, :], -1, state)
        cols.append(col)
        state = state & ~(torch.ones_like(col) << col)
    return torch.cat(cols[::-1], dim=-1)


def masked_linear_sum_assignment(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
) -> torch.Tensor:
    """Matching over a padded cost matrix ``[..., n, n]``; ``row_to_col
    [..., n]``.

    Pairs involving invalid rows or columns get a uniform large cost, so
    valid rows match valid columns when the counts agree. Entries of
    invalid rows are arbitrary.
    """
    pair_valid = row_valid[..., :, None] & col_valid[..., None, :]
    padded = torch.where(pair_valid, cost, torch.full_like(cost, PAD_COST))
    if cost.shape[-1] > 8:
        raise NotImplementedError(
            "matching of more than 8 instances (the Jonker-Volgenant "
            "solver) is not ported yet"
        )
    return linear_sum_assignment_dp(padded)
