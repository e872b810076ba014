"""ms/step of each phase of the full recipe, warmup and residual.

Counterpart of the JAX package's ``scripts/steptime.py``::

    python -m vsrd_tpu_torch.scripts.steptime [--rays 1000] [--samples 100]
    python -m vsrd_tpu_torch.scripts.steptime --frames 8          # 8 co-optimized frames
    python -m vsrd_tpu_torch.scripts.steptime --instances 24 --layout kitti --group-skip
    python -m vsrd_tpu_torch.scripts.steptime --device cpu --views 2 --height 32 \\
        --width 48 --instances 2 --rays 8 --samples 4 --chunk 2 --repeats 1   # rehearsal

On the bench scenes (``bench_common.bench_frames``: the JAX scripts'
``synthetic_frame(PRNGKey(i))``, 17 views at 376x1408), it times a chunk of
``--chunk`` steps of the box-only warmup phase (from step 0) and of the
residual phase (from step 2000) with ``bench_common.time_chunk``: one
untimed chunk, then ``--repeats`` timed ones from the same state. It
prints the JAX script's line with the spread of the repeats added: ms/step
of each phase (median, min-max), the estimate of a 3000-step run (1000
warmup, 2000 residual steps) and that over the frames. ``--frames F > 1``
stacks the first F scenes (``sharded.stack_frames``) with parameters from
``init_params_batched``, so each step launches K4a-c once for all frames.

The JAX flags ``--fwd-tile`` and ``--bwd-tile`` (Pallas tile sizes) have
no counterpart: the CUDA kernels choose their own launch shapes.
``--height`` and ``--width`` are the port's, for rehearsals at small
sizes. ``--out`` writes the report as JSON.
"""

from __future__ import annotations

import argparse

from ..pipeline import optimize as opt
from . import bench_common as bc

NUM_STEPS, WARMUP_STEPS, RESIDUAL_START = 3000, 1000, 2000


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--views", type=int, default=17)
    parser.add_argument("--height", type=int, default=bc.IMAGE_SIZE[0])
    parser.add_argument("--width", type=int, default=bc.IMAGE_SIZE[1])
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--rays", type=int, default=1000)
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--chunk", type=int, default=100)
    parser.add_argument("--repeats", type=int, default=3, help="timed chunks per phase")
    parser.add_argument("--post-only", action="store_true")
    parser.add_argument("--box-coarse", action="store_true",
                        help="kernel_box_coarse=True (box-only coarse pass)")
    parser.add_argument("--layout", default="compact", choices=("compact", "kitti"),
                        help="instance placement: compact (z 8-16) or kitti (z 5-80, "
                             "realistic spread)")
    skip_group = parser.add_mutually_exclusive_group()
    skip_group.add_argument("--group-skip", action="store_true",
                            help="enable kernel_group_skip (default off)")
    skip_group.add_argument("--no-group-skip", action="store_true",
                            help="force-disable kernel_group_skip")
    parser.add_argument("--frames", type=int, default=1,
                        help=">1: co-optimize F stacked frames")
    parser.add_argument("--out", help="write the report as JSON to this path")
    return parser.parse_args(argv)


def make_config(args) -> opt.OptimizationConfig:
    """The JAX script's config for the same flags (``pallas_*`` ->
    ``kernel_*``)."""
    overrides = {}
    if args.box_coarse:
        overrides["kernel_box_coarse"] = True
    if args.group_skip:
        overrides["kernel_group_skip"] = True
    if args.no_group_skip:
        overrides["kernel_group_skip"] = False
    return opt.OptimizationConfig(num_steps=NUM_STEPS, warmup_steps=WARMUP_STEPS,
                                  num_rays=args.rays, num_samples=args.samples,
                                  checkpoint_interval=args.chunk, **overrides)


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = bc.prepare_device(args.device)
    cfg = make_config(args)
    frames = bc.bench_frames(args.frames, args.views, (args.height, args.width),
                             args.instances, args.layout, device=args.device)
    frame, params, optimizer, state = bc.bench_state(frames, cfg, args.device)
    del frames
    phases = {}
    if not args.post_only:
        phases["warmup"] = bc.time_chunk(params, state, frame, cfg, 0, args.chunk, optimizer,
                                         args.repeats)
    phases["residual"] = bc.time_chunk(params, state, frame, cfg, RESIDUAL_START, args.chunk,
                                       optimizer, args.repeats)
    warm = phases["warmup"]["median"] if "warmup" in phases else float("nan")
    post = phases["residual"]["median"]
    estimate = (WARMUP_STEPS * warm + (NUM_STEPS - WARMUP_STEPS) * post) / 1e3
    per_frame = estimate / args.frames

    def spread(name):
        if name not in phases:
            return ""
        return f" ({phases[name]['min']:.2f}-{phases[name]['max']:.2f})"

    print(f"frames={args.frames}  warmup {warm:.2f}{spread('warmup')} ms/step  "
          f"post-warmup {post:.2f}{spread('residual')} ms/step  batch-estimate "
          f"{estimate:.1f} s  per-frame {per_frame:.1f} s  on {card}", flush=True)
    report = {
        "workload": {k: v for k, v in vars(args).items() if k != "out"},
        "card": card,
        "ms_per_step": {name: {k: t[k] for k in ("median", "min", "max", "samples")}
                        for name, t in phases.items()},
        # with --post-only there is no warmup time, hence no estimate
        "batch_estimate_s": estimate if "warmup" in phases else None,
        "per_frame_s": per_frame if "warmup" in phases else None,
    }
    bc.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
