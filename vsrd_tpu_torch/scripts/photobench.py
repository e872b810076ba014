"""The photometric branch's cost: residual-phase ms/step at photometric
weight 1.0 against 0.0.

Counterpart of the JAX package's ``scripts/photobench.py``::

    python -m vsrd_tpu_torch.scripts.photobench [--chunk 100]
    python -m vsrd_tpu_torch.scripts.photobench --device cpu --views 2 --height 32 \\
        --width 48 --instances 2 --chunk 2 --rays 8 --samples 4 --surface-rays 8 \\
        --surface-iterations 20 --repeats 1          # rehearsal

On the bench scene with its gray images (``synthetic_frame(PRNGKey(0))``,
17 views at 376x1408, 8 instances), each arm (weight 0.0, then 1.0) times a
residual-phase chunk of ``--chunk`` steps from step 2000 with
``bench_common.time_chunk``; the warmup phase has no photometric branch,
so its chunk is timed once, for both arms. Each arm's estimate of a
3000-step run takes 1000 warmup and 2000 residual steps. At weight 1.0
each residual step also sphere-traces 100 surfels per frame with the
sphere-trace kernel and warps their 11x11 patches into every view. It
prints each arm's result and then the JAX report's keys as one JSON
object; ``--out`` writes the whole report as JSON (the script writes no
other file).

``--rays``, ``--samples``, ``--surface-rays``, ``--surface-iterations`` and
``--repeats`` are the port's, for rehearsals at small sizes; their defaults
are the JAX script's recipe.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..pipeline import optimize as opt
from . import bench_common as bc

NUM_STEPS, WARMUP_STEPS, RESIDUAL_START = 3000, 1000, 2000
WEIGHTS = (0.0, 1.0)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--views", type=int, default=17)
    parser.add_argument("--height", type=int, default=bc.IMAGE_SIZE[0])
    parser.add_argument("--width", type=int, default=bc.IMAGE_SIZE[1])
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=100)
    parser.add_argument("--repeats", type=int, default=3, help="timed chunks per arm")
    defaults = opt.OptimizationConfig()
    parser.add_argument("--rays", type=int, default=defaults.num_rays)
    parser.add_argument("--samples", type=int, default=defaults.num_samples)
    parser.add_argument("--surface-rays", type=int, default=defaults.surface_num_rays)
    parser.add_argument("--surface-iterations", type=int,
                        default=defaults.surface_num_iterations)
    parser.add_argument("--out", help="write the report as JSON to this path")
    return parser.parse_args(argv)


def make_config(args, weight: float) -> opt.OptimizationConfig:
    """The JAX script's config of the arm at ``weight``."""
    return opt.OptimizationConfig(num_steps=NUM_STEPS, warmup_steps=WARMUP_STEPS,
                                  num_rays=args.rays, num_samples=args.samples,
                                  checkpoint_interval=args.chunk, photometric_weight=weight,
                                  surface_num_rays=args.surface_rays,
                                  surface_num_iterations=args.surface_iterations)


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = bc.prepare_device(args.device)
    frames = bc.bench_frames(1, args.views, (args.height, args.width), args.instances,
                             with_images=True, device=args.device)
    results, warm = {}, None
    for weight in WEIGHTS:
        cfg = make_config(args, weight)
        frame, params, optimizer, state = bc.bench_state(frames, cfg, args.device)
        if warm is None:
            # the warmup phase has no photometric branch: timed once for both arms
            warm = bc.time_chunk(params, state, frame, cfg, 0, args.chunk, optimizer,
                                 args.repeats)
        post = bc.time_chunk(params, state, frame, cfg, RESIDUAL_START, args.chunk,
                             optimizer, args.repeats)
        s_frame = (WARMUP_STEPS * warm["median"]
                   + (NUM_STEPS - WARMUP_STEPS) * post["median"]) / 1e3
        key = f"w{weight:g}"
        results[key] = {
            "warmup_ms_per_step": warm["median"],
            "post_ms_per_step": post["median"],
            "post_ms_min_max": [post["min"], post["max"]],
            "s_per_frame_3000": s_frame,
            "photometric_loss_last": float(np.asarray(
                post["scalars"].get("photometric_loss", np.zeros(1)))[-1]),
        }
        print(key, results[key], f"on {card}", flush=True)
    delta = results["w1"]["s_per_frame_3000"] - results["w0"]["s_per_frame_3000"]
    report = {
        "workload": {k: v for k, v in vars(args).items() if k != "out"},
        "card": card,
        "recipe_note": "the bench scene (17 views 376x1408, 8 instances, 1000 rays, 100+100 "
                       "samples); the photometric branch adds sphere tracing (100 rays per "
                       "frame, the sphere-trace kernel) and 11x11 patch homography warps "
                       "per residual step; per-step times are the median of the timed "
                       "chunks after one untimed chunk, on optimize_chunk",
        "results": results,
        "photometric_overhead_ms_per_step": (results["w1"]["post_ms_per_step"]
                                             - results["w0"]["post_ms_per_step"]),
        "photometric_overhead_s_per_frame": delta,
    }
    print(json.dumps({"photobench": results, "overhead_s_per_frame": delta,
                      "card": card}), flush=True)
    bc.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
