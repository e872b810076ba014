"""Multi-process runtime over ``torch.distributed``: initialization, frame
sharding, object collectives, a differentiable all-reduce and a rank-aware
logger.

Counterpart of ``vsrd_tpu/parallel/distributed.py``. Labeling is
embarrassingly parallel: each process takes a static round-robin share of
the target frames and no gradient crosses processes, so the object
collectives here serve bookkeeping only. ``all_reduce_sum`` serves the
ray-sharded step of ``pipeline/sharded.py``, whose loss sums across the
processes of one frame. The rendezvous comes from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from Slurm's (``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID``, with ``MASTER_ADDR``/``MASTER_PORT`` or the launch node's
address); the backend is NCCL with a card and gloo without one. With one
process nothing is initialized and every function works locally.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_PORT = 29500


def rendezvous(launcher: str | None = None, environ=None) -> dict | None:
    """``{"rank", "world_size", "local_rank", "address", "port"}`` from the
    launcher's environment, or None when it names no process group.
    ``launcher`` is ``"torchrun"``, ``"slurm"`` or None (whichever is set,
    torchrun's first)."""
    env = os.environ if environ is None else environ
    if launcher not in (None, "torchrun", "slurm"):
        raise ValueError(f"unknown launcher {launcher!r}")
    if launcher in (None, "torchrun") and "RANK" in env and "WORLD_SIZE" in env:
        return dict(rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                    local_rank=int(env.get("LOCAL_RANK", 0)),
                    address=env.get("MASTER_ADDR", "localhost"),
                    port=int(env.get("MASTER_PORT", DEFAULT_PORT)))
    if launcher in (None, "slurm") and "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        return dict(rank=int(env["SLURM_PROCID"]), world_size=int(env["SLURM_NTASKS"]),
                    local_rank=int(env.get("SLURM_LOCALID", 0)),
                    address=env.get("MASTER_ADDR", env.get("SLURM_LAUNCH_NODE_IPADDR",
                                                           "localhost")),
                    port=int(env.get("MASTER_PORT", DEFAULT_PORT)))
    if launcher is not None:
        names = ("RANK and WORLD_SIZE" if launcher == "torchrun"
                 else "SLURM_PROCID and SLURM_NTASKS")
        raise RuntimeError(f"--launcher {launcher}: {names} are not set; start the driver "
                           f"under {'torchrun' if launcher == 'torchrun' else 'srun'}")
    return None


def initialize(launcher: str | None = None, backend: str | None = None) -> None:
    """Join the process group that the launcher's environment names (see
    ``rendezvous``); a no-op for one process or when already joined. The
    backend is NCCL when a card is present, else gloo, unless ``backend``
    names one; with NCCL each process takes the card of its local rank."""
    if dist.is_initialized():
        return
    spec = rendezvous(launcher)
    if spec is None or spec["world_size"] <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(spec["local_rank"] % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{spec['address']}:{spec['port']}",
                            world_size=spec["world_size"], rank=spec["rank"])


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def shard_indices(num_items: int, shard: int | None = None,
                  num_shards: int | None = None) -> np.ndarray:
    """This process's frame indices: round-robin, ``shard::num_shards``."""
    shard = process_index() if shard is None else shard
    num_shards = process_count() if num_shards is None else num_shards
    return np.arange(shard, num_items, num_shards)


def shard_list(items: Sequence[Any], shard: int | None = None,
               num_shards: int | None = None) -> list[Any]:
    return [items[i] for i in shard_indices(len(items), shard, num_shards)]


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of process ``src`` on every process (pickled)."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_ragged(array: np.ndarray) -> list[np.ndarray]:
    """Every process's array, whose leading sizes may differ, as a list in
    process order; any dtype round-trips exactly (pickled)."""
    array = np.ascontiguousarray(array)
    if process_count() == 1:
        return [array]
    out = [None] * process_count()
    dist.all_gather_object(out, array)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the cotangent over the
    same group, as ``jax.lax.psum`` transposes to ``psum``."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` summed over ``group`` (a new tensor; the input is left as
    it was). Differentiable: each process's gradient is the sum of every
    process's cotangent, so a loss that every process computes alike from
    the sum hands each process S times its own share (S the group's size),
    and averaging the gradients over the group recovers the gradient of
    the sum."""
    return _AllReduceSum.apply(tensor, group)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def get_logger(name: str = "vsrd_tpu_torch", rank_zero_only: bool = True) -> logging.Logger:
    """A logger that prints its process index; with ``rank_zero_only`` it
    is silent on every process but the first."""
    logger = logging.getLogger(name)
    if rank_zero_only and not is_primary():
        logger.setLevel(logging.CRITICAL)
    elif not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            f"%(levelname)s: %(asctime)s: [proc {process_index()}] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
