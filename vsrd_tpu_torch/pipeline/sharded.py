"""Stacked frames and the multi-process training step: frames over ``dp``,
rays over ``sp``, on ``torch.distributed``.

Counterpart of ``vsrd_tpu/pipeline/sharded.py``. The JAX package runs one
``shard_map`` step over a ``(dp, sp)`` device mesh; here the mesh is a
world of ``dp x sp`` processes (``make_groups``): process ``r`` holds the
frames of dp index ``r // sp`` (stacked, ``stack_frames``) and renders the
rays of sp index ``r % sp``. The step is ``optimize.train_step`` with the
process group of its sp index (``sp_group``): the silhouette and eikonal
means sum their numerators and denominators over the group, the
photometric loss is averaged over it and the gradients are averaged over
it before Adam, so every process of a group takes the update that one
process with all of the group's rays would take. Nothing crosses dp:
labeling frames is independent, as in the JAX package.

On the card each process launches the field kernels (K4a/K4c/K4b with a
frame grid axis for its stacked frames, K1-K3 for one) on its slice of
the rays. NCCL wants one card per process; gloo lets several processes
share one card, or run on the CPU.

Run it as a module (the counterpart of ``__graft_entry__.dryrun_multichip``)::

    torchrun --nproc_per_node 4 -m vsrd_tpu_torch.pipeline.sharded --dp 2 --sp 2
    torchrun --nproc_per_node 4 -m vsrd_tpu_torch.pipeline.sharded --dp 2 --sp 2 \\
        --backend gloo                       # four processes on one card
    torchrun --nproc_per_node 2 -m vsrd_tpu_torch.pipeline.sharded --dp 1 --sp 2 \\
        --backend gloo --device cpu          # on the CPU, at a small size

It takes a few box-only and residual steps on synthetic frames and prints
one JSON line per step with every frame's loss.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import distributed
from ..utils.watchdog import deadline
from . import optimize as opt
from .frame import FrameData, synthetic_frame


def stack_frames(frames: list[FrameData]) -> FrameData:
    """Stack equally shaped FrameData along a new leading frame axis.

    ``target_index`` becomes an int64 tensor ``[F]`` on the frames' device;
    ``gray_images`` stays ``None`` when no frame has them, and a mix of
    frames with and without them is refused."""
    first = frames[0]
    if any(f.image_size != first.image_size for f in frames):
        raise ValueError("stacked frames must share one image size")
    fields = {}
    for field in dataclasses.fields(FrameData):
        values = [getattr(f, field.name) for f in frames]
        if field.name == "image_size":
            fields[field.name] = first.image_size
        elif field.name == "target_index":
            fields[field.name] = torch.as_tensor([int(v) for v in values], device=first.device)
        elif field.name == "gray_images" and all(v is None for v in values):
            fields[field.name] = None
        elif field.name == "gray_images" and any(v is None for v in values):
            raise ValueError("stacked frames must all have gray_images or all lack them")
        else:
            fields[field.name] = torch.stack(values)
    return FrameData(**fields)


@dataclasses.dataclass(frozen=True)
class ShardGroups:
    """This process's place in the ``dp x sp`` world: its dp and sp indices
    and the process group of the processes that share its frames (``None``
    when ``sp`` is 1, so that a dp-only step is the single-process step)."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    sp_group: object = None

    def frame_range(self, num_frames: int) -> range:
        """The global indices of this process's frames: a contiguous share
        of ``num_frames // dp``, as ``P("dp")`` shards the frame axis."""
        if num_frames % self.dp:
            raise ValueError(f"{num_frames} frames do not split over dp={self.dp}")
        local = num_frames // self.dp
        return range(self.dp_index * local, (self.dp_index + 1) * local)


def make_groups(dp: int | None = None, sp: int | None = None) -> ShardGroups:
    """The counterpart of ``make_mesh``: the world's processes as ``dp x sp``.

    Rank ``r`` is dp index ``r // sp`` and sp index ``r % sp``; one process
    group per dp index holds its sp ranks (every process creates every
    group, in the same order, as ``dist.new_group`` requires). Without an
    initialized process group the world is this one process. Refuses
    ``dp * sp`` other than the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None and sp is None:
        dp, sp = world, 1
    elif dp is None:
        dp = world // sp
    elif sp is None:
        sp = world // dp
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"mesh {dp}x{sp} != {world} processes")
    sp_group = None
    if sp > 1:
        for index in range(dp):
            group = dist.new_group(list(range(index * sp, (index + 1) * sp)))
            if index == rank // sp:
                sp_group = group
    return ShardGroups(dp, sp, rank // sp, rank % sp, sp_group)


def init_sharded_state(seed: int, num_frames: int, max_instances: int,
                       cfg: opt.OptimizationConfig, groups: ShardGroups,
                       device: torch.device | str = "cuda"):
    """This process's frames' params and Adam state, stacked along a
    leading frame axis on ``device``. Frame ``f`` takes the ``f``-th draw of
    one CPU generator seeded with ``seed``, as ``init_params_batched``
    draws them, so a frame starts from the same params whatever ``dp``
    is."""
    frames = groups.frame_range(num_frames)
    generator = torch.Generator(device="cpu").manual_seed(seed)
    per_frame = [opt.init_params(generator, max_instances, cfg) for _ in range(frames.stop)]
    params = opt.tree_map(lambda t: t.to(device), opt.tree_stack(per_frame[frames.start:]))
    return params, opt.Adam(cfg).init(params)


def make_sharded_train_step(groups: ShardGroups, cfg: opt.OptimizationConfig):
    """``step_fn(params, opt_state, local_frames, step, seed, ray_indices=None)
    -> scalars``: one step of this process's stacked frames with its
    slice of the rays, updating ``params`` and ``opt_state`` in place.

    The step's random stream is ``step_generator`` of ``seed`` folded with
    the dp index (the JAX package folds its key with it), so the dp
    ranks' frames draw independently and the sp ranks of one group draw
    the same rays. ``ray_indices [F_local, R]``, this process's frames'
    whole schedule (cut to the sp slice inside), replaces the ray draw, as
    the JAX step's ``with_ray_schedule`` does."""
    optimizer = opt.Adam(cfg)

    def step_fn(params, opt_state, local_frames: FrameData, step: int, seed: int,
                ray_indices: torch.Tensor | None = None):
        generator = opt.step_generator(opt.fold_seed(seed, groups.dp_index), step,
                                       local_frames.device)
        return opt.train_step(params, opt_state, local_frames, step, cfg, optimizer,
                              generator, ray_indices=ray_indices, sp_group=groups.sp_group)

    return step_fn


# the entry point's fixed seed (params and steps), as the JAX dry run's fixed keys,
# and the seconds it allows the rendezvous and the first step
ENTRY_SEED = 0
FIRST_STEP_TIMEOUT_S = 600.0


def _parse(argv):
    parser = argparse.ArgumentParser(
        prog="python -m vsrd_tpu_torch.pipeline.sharded",
        description="A few dp x sp sharded steps on synthetic frames (run under torchrun).")
    parser.add_argument("--dp", type=int, default=None)
    parser.add_argument("--sp", type=int, default=None)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--frames-per-rank", type=int, default=2,
                        help="stacked frames of each dp index")
    parser.add_argument("--warmup-steps", type=int, default=2)
    parser.add_argument("--residual-steps", type=int, default=2)
    parser.add_argument("--num-rays", type=int, default=1000)
    parser.add_argument("--num-samples", type=int, default=100)
    parser.add_argument("--num-views", type=int, default=17)
    parser.add_argument("--height", type=int, default=376)
    parser.add_argument("--width", type=int, default=1408)
    parser.add_argument("--num-instances", type=int, default=8)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    if args.backend == "nccl" and args.device == "cpu":
        raise SystemExit("--backend nccl needs --device cuda")
    spec = distributed.rendezvous("torchrun")
    with deadline(FIRST_STEP_TIMEOUT_S, "rendezvous and first step"):
        if args.device == "cuda":
            if args.backend == "nccl" and spec["world_size"] > torch.cuda.device_count():
                raise SystemExit(f"NCCL takes one card per process: {spec['world_size']} "
                                 f"processes, {torch.cuda.device_count()} cards (use --backend "
                                 f"gloo to share cards)")
            device = torch.device("cuda", spec["local_rank"] % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        # env:// reads torchrun's variables and joins its agent's store
        dist.init_process_group(args.backend)
        groups = make_groups(args.dp, args.sp)
        num_frames = groups.dp * args.frames_per_rank
        frame_ids = groups.frame_range(num_frames)
        frames = stack_frames([
            synthetic_frame(f, num_views=args.num_views, image_size=(args.height, args.width),
                            num_instances=args.num_instances, max_instances=args.num_instances,
                            device=device)
            for f in frame_ids])
        steps = args.warmup_steps + args.residual_steps
        cfg = opt.OptimizationConfig(num_steps=steps, warmup_steps=args.warmup_steps,
                                     num_rays=args.num_rays, num_samples=args.num_samples,
                                     checkpoint_interval=steps, metric_interval=steps)
        params, opt_state = init_sharded_state(ENTRY_SEED, num_frames, args.num_instances, cfg,
                                               groups, device)
        step_fn = make_sharded_train_step(groups, cfg)

        def run(step):
            start = time.perf_counter()
            losses = step_fn(params, opt_state, frames, step, ENTRY_SEED)["loss"].cpu().tolist()
            seconds = time.perf_counter() - start
            rows = distributed.all_gather_ragged(np.asarray(
                [[groups.sp_index, f, loss] for f, loss in zip(frame_ids, losses)]))
            if dist.get_rank() == 0:
                by_frame = {int(f): loss for block in rows for sp_index, f, loss in block
                            if sp_index == 0}
                phase = "residual" if step >= cfg.warmup_steps else "warmup"
                print(json.dumps({"step": step, "phase": phase, "seconds": seconds,
                                  "loss": [by_frame[f] for f in range(num_frames)]}),
                      flush=True)

        run(0)
    for step in range(1, steps):
        run(step)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
