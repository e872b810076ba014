"""Auto-label one frame with the PyTorch port's full recipe and report its
time and quality.

    python3 tools/torch_port/quality.py                 # on one CUDA card
    python3 tools/torch_port/quality.py --frames 8      # 8 co-optimized frames
    python3 tools/torch_port/quality.py --device cpu --views 2 --size 32 48 \
        --instances 3 --steps 4 --warmup 2 --rays 16 --samples 6    # rehearsal

Runs ``optimize_frame`` with the default ``OptimizationConfig`` (3000 steps,
1000 of them box-only warmup, 1000 rays, 100+100 samples) on the 17-view
376x1408 synthetic frame with 8 instances. It prints the seconds per
frame (host clock, after a warm-up build of the kernels), the 3D IoU at
every checkpoint and the final one, and the card's name and power limit.

The default ``--seed`` is the scene that ``bench.py`` builds from
``PRNGKey(0)`` (``jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)``), so
the final ``iou_3d`` compares with the JAX package's on the same scene.
The parameters are initialised from ``--init-seed``.

``--frames F`` co-optimizes F frames with ``optimize_frames_batched``: the
``--seed`` scene as frame 0 and the scenes of seeds 1..F-1. It reports the
seconds per frame (the run's time over F) and each frame's final
``iou_3d``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import card_name_and_power, synthetic_frames  # noqa: E402
from vsrd_tpu_torch.pipeline import optimize as opt, sharded  # noqa: E402
from vsrd_tpu_torch.rendering import field_kernels as fk  # noqa: E402


def card_label(device: str) -> str:
    if device != "cuda":
        return "cpu (no device metric)"
    return card_name_and_power()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=31327077, help="synthetic scene seed")
    parser.add_argument("--init-seed", type=int, default=1)
    parser.add_argument("--views", type=int, default=17)
    parser.add_argument("--size", type=int, nargs=2, default=(376, 1408))
    parser.add_argument("--instances", type=int, default=8)
    defaults = opt.OptimizationConfig()
    parser.add_argument("--steps", type=int, default=defaults.num_steps)
    parser.add_argument("--warmup", type=int, default=defaults.warmup_steps)
    parser.add_argument("--rays", type=int, default=defaults.num_rays)
    parser.add_argument("--samples", type=int, default=defaults.num_samples)
    parser.add_argument("--frames", type=int, default=1,
                        help="co-optimized frames (1: the single-frame path)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu for a rehearsal)")

    card = card_label(args.device)
    print(card, flush=True)
    if args.device == "cuda":
        fk.build_library()
    frames = synthetic_frames([args.seed] + list(range(1, args.frames)), args.device,
                              num_views=args.views, image_size=tuple(args.size),
                              num_instances=args.instances, max_instances=args.instances)
    frame = frames[0] if args.frames == 1 else sharded.stack_frames(frames)
    del frames
    interval = min(500, args.steps)
    cfg = opt.OptimizationConfig(num_steps=args.steps, warmup_steps=args.warmup,
                                 num_rays=args.rays, num_samples=args.samples,
                                 checkpoint_interval=interval,
                                 metric_interval=min(defaults.metric_interval, interval))

    fk.reset_launch_counts()
    if args.device == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    if args.frames == 1:
        _, scalars = opt.optimize_frame(frame, args.init_seed, cfg)
    else:
        _, scalars = opt.optimize_frames_batched(frame, args.init_seed, cfg)
    if args.device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    if not all(np.all(np.isfinite(v)) for v in scalars.values()):
        raise SystemExit("non-finite scalars in the run")
    # [steps] or [steps, F] -> [F, steps]
    iou, iou_bev, loss = (np.atleast_2d(scalars[k].T) for k in ("iou_3d", "iou_bev", "loss"))
    print(f"[quality] seed {args.seed}, F={args.frames}, {args.steps} steps ({args.warmup} "
          f"warmup), {args.views} views {args.size[0]}x{args.size[1]}, {args.instances} "
          f"instances, {args.rays} rays, {args.samples}+{args.samples} samples: "
          f"{seconds:.2f} s in all, {seconds / args.frames:.2f} s/frame on {card}", flush=True)
    for f in range(args.frames):
        print(f"[quality] frame {f}: final iou_3d {iou[f, -1]:.4f} iou_bev {iou_bev[f, -1]:.4f} "
              f"loss {loss[f, -1]:.4f}; iou_3d every {interval} steps: "
              f"{[round(float(iou[f, i]), 4) for i in range(interval - 1, args.steps, interval)]}",
              flush=True)
    print(f"[quality] kernel launches K1/K4a {fk.field_forward.launches} "
          f"K2/K4c {fk.field_backward.launches} K3/K4b {fk.field_dir_forward.launches} "
          f"(with F > 1 frames: {fk.field_forward.batched_launches}, "
          f"{fk.field_backward.batched_launches}, {fk.field_dir_forward.batched_launches})",
          flush=True)


if __name__ == "__main__":
    main()
