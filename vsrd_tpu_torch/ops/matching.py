"""Bipartite matching that stays on the device.

Counterpart of ``vsrd_tpu/ops/matching.py``. The reference calls
``scipy.optimize.linear_sum_assignment`` on the host every step, which
forces a device-to-host copy per step. Here, as in the JAX package, up to 8
instances go through a subset DP (a handful of tensor ops on whatever device
the cost lives on) and more through the Jonker-Volgenant (JV) solver: on a
card the hand-written kernel ``csrc/matching.cu`` (one launch for all
frames, no host synchronisation), on the CPU its plain twin, a
transcription of the JAX solver. Both give the JAX solver's ``row_to_col``
entry for entry from the same f32 cost.
"""

from __future__ import annotations

import ctypes

import torch

_INF = 1e18
# Uniform cost for any pair touching a padded instance: real costs are
# O(1) (negated DIoU), so mixed valid/pad matches are strictly worse than
# valid/valid + pad/pad.
PAD_COST = 1e6
# the JV kernel's largest n (its cost lives in n^2 floats of dynamic shared
# memory: 64 KB at 128)
JV_MAX_N = 128


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
    cost = cost.to(torch.float32)

    f = torch.full((*lead, num_states), float("inf"), device=device)
    f[..., 0].fill_(0.0)    # a kernel: assigning a host number copies it over
    choices = []
    for row in range(n):
        # candidate[c][S] = f[S \ {c}] + cost[row, c], valid iff c in S
        candidate = torch.where(has, f[..., without] + cost[..., row, :, None], float("inf"))
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


def _jv_one(cost: torch.Tensor) -> torch.Tensor:
    """The JAX solver (``vsrd_tpu/ops/matching.py:27-131``) step for step
    on one ``[n, n]`` f32 cost: rows in turn, each a Dijkstra run over the
    reduced costs until a free column is reached, then the augmenting path.
    Its data-dependent loops cost nothing on CPU tensors."""
    n = cost.shape[0]
    c = torch.full((n + 1, n + 1), _INF, dtype=torch.float32)
    c[1:, 1:] = cost
    u = torch.zeros(n + 1)
    v = torch.zeros(n + 1)
    p = torch.zeros(n + 1, dtype=torch.int64)
    for i in range(1, n + 1):
        p[0] = i
        up = u[p]
        minv = torch.full((n + 1,), _INF)
        way = torch.zeros(n + 1, dtype=torch.int64)
        used = torch.zeros(n + 1, dtype=torch.bool)
        j0 = 0
        while True:
            used[j0] = True
            cur = c[p[j0]] - up[j0] - v
            better = (cur < minv) & ~used
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used, _INF, minv)
            j1 = int(torch.argmin(masked))             # ties: the lowest column
            delta = masked[j1]
            add = torch.where(used, delta, 0.0)
            up = up + add
            v = v - add
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
            if int(p[j1]) == 0:
                break
        # the JAX solver also scatters the free columns' entries onto u[0],
        # the phantom row's potential, which no result reads
        matched = p != 0
        u[p[matched]] = up[matched]
        while j0 != 0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    row_to_col = torch.empty(n, dtype=torch.int64)
    row_to_col[p[1:] - 1] = torch.arange(n)
    return row_to_col


def linear_sum_assignment_twin(cost: torch.Tensor) -> torch.Tensor:
    """The JV kernel's plain twin: ``[..., n, n] -> row_to_col [..., n]``,
    frame by frame on the host."""
    n = cost.shape[-1]
    flat = cost.detach().to("cpu", torch.float32).reshape(-1, n, n)
    out = torch.stack([_jv_one(f) for f in flat]) if len(flat) else torch.empty(0, n)
    return out.to(torch.int64).reshape(cost.shape[:-1]).to(cost.device)


def jv_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Launch the JV kernel on ``[..., n, n]`` costs on a card (1 <= n <=
    ``JV_MAX_N``): one CTA per leading index, ``row_to_col [..., n]`` int64.
    Counts its launches in ``jv_assignment.launches``."""
    from ..rendering.field_kernels import build_library

    if cost.ndim < 2 or cost.shape[-2] != cost.shape[-1] or not 1 <= cost.shape[-1] <= JV_MAX_N:
        raise ValueError(f"the JV kernel takes square costs [..., n, n] with 1 <= n <= "
                         f"{JV_MAX_N}, not {tuple(cost.shape)} (so DETR's num_queries is at most "
                         f"{JV_MAX_N} on a card)")
    if cost.device.type != "cuda":
        raise ValueError(f"the JV kernel runs on CUDA tensors, not {cost.device}")
    n = cost.shape[-1]
    lead = cost.shape[:-2]
    flat = cost.detach().to(torch.float32).reshape(-1, n, n).contiguous()
    out = torch.empty(*lead, n, dtype=torch.int64, device=cost.device)
    if flat.shape[0] == 0:
        return out
    lib = build_library()
    code = lib.vsrd_jv_assignment(
        flat.shape[0], n, ctypes.c_void_p(flat.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"JV jv_assignment_kernel failed with CUDA error {code}")
    jv_assignment.launches += 1
    return out


def reset_launch_counts():
    jv_assignment.launches = 0


reset_launch_counts()


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Minimum-cost perfect matching on square costs ``[..., n, n]``:
    ``row_to_col [..., n]``, by JV. CUDA tensors go through the kernel
    (or raise: there is no fallback), CPU tensors through its twin."""
    if cost.device.type == "cuda":
        return jv_assignment(cost)
    if cost.device.type == "cpu":
        return linear_sum_assignment_twin(cost)
    raise ValueError(f"no JV solver for device {cost.device}")


def masked_linear_sum_assignment(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
) -> torch.Tensor:
    """Matching over a padded cost matrix ``[..., n, n]``; ``row_to_col
    [..., n]``.

    Pairs involving invalid rows or columns get a uniform large cost, so
    valid rows match valid columns when the counts agree. Entries of
    invalid rows are arbitrary, but the same as the JAX package's. The
    subset DP takes n <= 8 and JV larger n, as in the JAX package.
    """
    pair_valid = row_valid[..., :, None] & col_valid[..., None, :]
    padded = torch.where(pair_valid, cost, PAD_COST)
    if cost.shape[-1] <= 8:
        return linear_sum_assignment_dp(padded)
    return linear_sum_assignment(padded)
