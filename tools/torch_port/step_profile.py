"""Where a step of the PyTorch port's loop spends its time, per phase.

    python3 tools/torch_port/step_profile.py                 # on one CUDA card
    python3 tools/torch_port/step_profile.py --frames 8      # 8 co-optimized frames
    python3 tools/torch_port/step_profile.py --frames 8 --residual-coarse
    python3 tools/torch_port/step_profile.py --photometric   # photometric weight 1.0
    python3 tools/torch_port/step_profile.py --device cpu    # rehearsal, tiny frame

For the box-only warmup phase (from step 0) and the residual-field phase
(from step ``warmup_steps``), after 3 warm steps: the unprofiled wall
time per step over one chunk of ``--wall-steps`` steps (host clock, ending
in a synchronize), then a chunk of ``--profiled-steps`` steps under
``torch.profiler``. From the profiled chunk it prints the device busy time
per step (the sum of the CUDA kernels' self time), the idle share of the
unprofiled step (1 - busy / wall), the kernel launches per step, the
kernels that take most device time and the host operators that take most
host time. On the card the scene is the bench scene at full width (17
views at 376x1408, 8 instances, 1000 rays, 100+100 samples).

``--frames F`` profiles the co-optimized batch instead: the bench scene
as frame 0 and the scenes of seeds 1..F-1, stacked, with params from
``init_params_batched``; a step then runs all F frames, and the report
adds the wall time per frame-step. ``--residual-coarse`` runs the coarse
pass with the residual field after warmup (``kernel_box_coarse=False``)
instead of box-only. ``--photometric`` sets the photometric weight to 1.0 on
frames with images, so that each residual step also runs the photometric
branch (one launch of ``march_kernel`` and ``finish_kernel``, the
sphere-trace kernel, for all frames).

Each field kernel's device time per step is printed by name: K1/K4a
(``rev_forward_kernel<.>``), K3/K4b (``tangent_forward_kernel<.>``), and the
three kernels of one K2/K4c call (stage 1 ``union_cotangent_kernel``,
stage 2 ``instance_backward_kernel``, then ``reduce_partials_kernel``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402
from chip_smoke import card_name_and_power, synthetic_frames  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vsrd_tpu_torch.pipeline import optimize as opt, sharded  # noqa: E402
from vsrd_tpu_torch.rendering import field_kernels as fk  # noqa: E402

FIELD_KERNELS = ("rev_forward_kernel", "tangent_forward_kernel", "union_cotangent_kernel",
                 "instance_backward_kernel", "reduce_partials_kernel", "march_kernel",
                 "finish_kernel")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--wall-steps", type=int, default=20)
    parser.add_argument("--profiled-steps", type=int, default=5)
    parser.add_argument("--frames", type=int, default=1,
                        help="co-optimized frames per step (1: the single-frame path)")
    parser.add_argument("--residual-coarse", action="store_true",
                        help="the coarse pass with the residual field (kernel_box_coarse=False)")
    parser.add_argument("--photometric", action="store_true",
                        help="the photometric branch at weight 1.0")
    args = parser.parse_args(argv)
    photometric = dict(photometric_weight=1.0 if args.photometric else 0.0)
    device = args.device
    seeds = [31327077] + list(range(1, args.frames))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (use --device cpu for a rehearsal)")
        card = card_name_and_power()
        fk.build_library()
        frames = synthetic_frames(seeds, device, with_images=args.photometric)
        cfg = opt.OptimizationConfig(kernel_box_coarse=not args.residual_coarse, **photometric)
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        card = "cpu (no device metric)"
        frames = synthetic_frames([0] + seeds[1:], device, num_views=2, image_size=(32, 48),
                                  num_instances=3, max_instances=3,
                                  with_images=args.photometric)
        cfg = opt.OptimizationConfig(num_steps=40, warmup_steps=10, num_rays=16, num_samples=6,
                                     kernel_box_coarse=not args.residual_coarse,
                                     surface_num_rays=8, surface_num_iterations=20,
                                     **photometric)
        activities = [ProfilerActivity.CPU]
    print(card, flush=True)
    if args.frames == 1:
        frame = frames[0]
        params = opt.tree_map(lambda t: t.to(device), opt.init_params(
            torch.Generator().manual_seed(1), frame.max_instances, cfg))
    else:
        frame = sharded.stack_frames(frames)
        params = opt.init_params_batched(1, args.frames, frame.max_instances, cfg, device)
    del frames
    optimizer = opt.Adam(cfg)
    state = optimizer.init(params)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for phase, first in (("warmup", 0), ("residual", cfg.warmup_steps)):
        opt.optimize_chunk(params, state, frame, 1, first, cfg, 3, optimizer)
        sync()
        start = time.perf_counter()
        opt.optimize_chunk(params, state, frame, 1, first + 3, cfg, args.wall_steps, optimizer)
        sync()
        wall = (time.perf_counter() - start) * 1e3 / args.wall_steps
        with profile(activities=activities) as prof:
            opt.optimize_chunk(params, state, frame, 1, first + 3 + args.wall_steps, cfg,
                               args.profiled_steps, optimizer)
            sync()
        events = prof.key_averages()
        per_step = 1e3 * args.profiled_steps
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / per_step
        launches = sum(e.count for e in kernels) / args.profiled_steps
        busy_text = (f"device busy {busy:.2f} ms/step; idle share {1 - busy / wall:.3f}; "
                     f"{launches:.0f} kernel launches/step" if device == "cuda"
                     else "device busy not measured")
        print(f"[profile] {phase} (steps {first + 3}-{first + 2 + args.wall_steps}), "
              f"F={args.frames}, photometric weight {cfg.photometric_weight}: "
              f"wall {wall:.2f} ms/step unprofiled "
              f"({wall / args.frames:.2f} per frame-step); {busy_text}; on {card}", flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    device {e.self_device_time_total / per_step:8.3f} ms/step "
                  f"{e.count / args.profiled_steps:6.0f}x  {e.key[:90]}", flush=True)
        for e in sorted((e for e in kernels if any(k in e.key for k in FIELD_KERNELS)),
                        key=lambda e: e.key):
            name = e.key.split("(")[0].replace("void ", "").replace("vsrd::", "")
            print(f"    field  {e.self_device_time_total / per_step:8.3f} ms/step "
                  f"{e.count / args.profiled_steps:6.0f}x  {name}", flush=True)
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:6]
        for e in host:
            print(f"    host   {e.self_cpu_time_total / per_step:8.3f} ms/step "
                  f"{e.count / args.profiled_steps:6.0f}x  {e.key[:60]}", flush=True)


if __name__ == "__main__":
    main()
