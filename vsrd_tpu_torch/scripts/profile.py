"""Device time of one chunk of steps by kernel and by category, from a
``torch.profiler`` trace.

Counterpart of the JAX package's ``scripts/profile.py``. Run it as a
module (a file named ``profile.py`` run by path would shadow the standard
library's ``profile``)::

    python -m vsrd_tpu_torch.scripts.profile                  # residual (post-warmup) phase
    python -m vsrd_tpu_torch.scripts.profile --phase warmup
    python -m vsrd_tpu_torch.scripts.profile --instances 16 --top 30
    python -m vsrd_tpu_torch.scripts.profile --frames 8        # 8 co-optimized frames
    python -m vsrd_tpu_torch.scripts.profile --frames 8 --residual-coarse
    python -m vsrd_tpu_torch.scripts.profile --photometric     # photometric weight 1.0
    python -m vsrd_tpu_torch.scripts.profile --device cpu --views 2 --height 32 --width 48 \\
        --instances 2 --rays 8 --samples 4 --steps 2          # rehearsal

On the bench scene (``synthetic_frame(PRNGKey(0))``, 17 views at
376x1408; with ``--frames F`` the first F bench scenes stacked, parameters
from ``init_params_batched``, so that a step runs all F frames), from step
0 (``--phase warmup``) or step 2000 (``post``), it
times one unprofiled chunk of ``--steps`` steps after an untimed one (wall
ms/step, ending in a synchronize), then runs the same chunk from the same
state under ``torch.profiler``. From the trace it prints the device ms per
step of the ``--top`` kernels, kernels of one template grouped by the name
before ``<``; the device ms per step of each category (``CATEGORIES``: the
field kernels K1-K4c by name, the JV kernel, the sphere trace, GEMM,
memcpy/memset, and elementwise/reduce for the rest); the busy ms per step
(the sum of the kernels' device time), the idle share of the unprofiled
step (1 - busy / wall), the kernel launches per step and, for F > 1, the
wall ms per frame-step. On the CPU it
prints the wall time and the host operators: device times are not
measured there. ``--out`` writes the report as JSON. The profiled chunk's
trace is written as a Chrome trace (``chrome://tracing``, Perfetto) to
``--trace-dir``/``trace.json``, as the JAX script writes its trace to its
``--trace-dir``; the field wrappers' calls are named in it
(``field_kernels.fused_field_with_grad``, ``fused_field_dir_forward``
and, on a card, ``field_backward``), and so is each step (``vsrd.step``,
its step index and phase in its args) and each of its stages
(``utils/spans.py``): ``vsrd.boxes``, ``vsrd.rays``, ``vsrd.render``,
``vsrd.backward``, ``vsrd.adam`` and ``vsrd.report`` (the last also
around the chunk's copy of its scalars to the host). The report gives each
stage's host ms per step and the whole step's (``host_ms_per_step_by_stage``,
the spans' whole host time, on a card the backward's wait for autograd's
device thread included).

The port's own switches: ``--residual-coarse`` runs the coarse pass with
the residual field after warmup (``kernel_box_coarse=False``) instead of
box-only; ``--photometric`` sets the photometric weight to 1.0 on scenes
with images, so that each residual step also runs the photometric branch
(one ``march_kernel`` and ``finish_kernel`` launch, the sphere trace, for
all frames). Without them the config is the JAX script's.
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..pipeline import optimize as opt
from ..utils.spans import STAGES, STEP
from . import bench_common as bc

NUM_STEPS, WARMUP_STEPS = 3000, 1000
PHASE_START = {"warmup": 0, "post": 2000}
FIELD_KERNELS = ("rev_forward_kernel", "tangent_forward_kernel", "union_cotangent_kernel",
                 "instance_backward_kernel", "reduce_partials_kernel")
# (category, substrings of the lower-cased kernel name); the first match wins
CATEGORIES = (
    ("field kernels", FIELD_KERNELS),
    ("jv", ("jv_assignment_kernel",)),
    ("sphere trace", ("march_kernel", "finish_kernel")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
    ("memcpy/memset", ("memcpy", "memset")),
)
OTHER = "elementwise/reduce"


def kernel_name(key: str) -> str:
    """A trace key without ``void``, its arguments and its template
    arguments: ``void vsrd::rev_forward_kernel<true, 384>(...)`` ->
    ``vsrd::rev_forward_kernel``."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    for mark in ("<", "("):
        name = name.split(mark)[0]
    return name.strip()


def category(name: str) -> str:
    lower = name.lower()
    for label, marks in CATEGORIES:
        if any(mark in lower for mark in marks):
            return label
    return OTHER


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--phase", choices=tuple(PHASE_START), default="post")
    parser.add_argument("--views", type=int, default=17)
    parser.add_argument("--height", type=int, default=bc.IMAGE_SIZE[0])
    parser.add_argument("--width", type=int, default=bc.IMAGE_SIZE[1])
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--rays", type=int, default=1000)
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--frames", type=int, default=1,
                        help=">1: co-optimize F stacked frames")
    parser.add_argument("--residual-coarse", action="store_true",
                        help="the coarse pass with the residual field (kernel_box_coarse=False)")
    parser.add_argument("--photometric", action="store_true",
                        help="the photometric branch at weight 1.0")
    parser.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(),
                                                            "vsrd_tpu_torch_trace"),
                        help="where the profiled chunk's Chrome trace (trace.json) goes")
    parser.add_argument("--out", help="write the report as JSON to this path")
    return parser.parse_args(argv)


def make_config(args) -> opt.OptimizationConfig:
    """The JAX script's config for the same flags, with the port's
    switches."""
    return opt.OptimizationConfig(num_steps=NUM_STEPS, warmup_steps=WARMUP_STEPS,
                                  num_rays=args.rays, num_samples=args.samples,
                                  checkpoint_interval=args.steps,
                                  kernel_box_coarse=not args.residual_coarse,
                                  photometric_weight=1.0 if args.photometric else 0.0)


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = bc.prepare_device(args.device)
    cfg = make_config(args)
    frames = bc.bench_frames(args.frames, args.views, (args.height, args.width),
                             args.instances, with_images=args.photometric, device=args.device)
    frame, params, optimizer, state = bc.bench_state(frames, cfg, args.device)
    del frames
    start = PHASE_START[args.phase]
    wall = bc.time_chunk(params, state, frame, cfg, start, args.steps, optimizer,
                         repeats=1)["median"]
    print(f"{args.phase} chunk, F={args.frames}: {wall:.3f} ms/step wall "
          f"({wall / args.frames:.3f} per frame-step) on {card}", flush=True)

    cuda = args.device == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        bc.run_chunk(params, state, frame, cfg, start, args.steps, optimizer)
    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"trace: {trace}", flush=True)
    events = prof.key_averages()
    per_step = 1e3 * args.steps      # profiler us over a chunk -> ms per step
    by_kernel, launches = collections.Counter(), collections.Counter()
    for e in events:
        # a record_function range (the field wrappers' names) is also reported on
        # the device, as the span of its kernels: it is not a kernel
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = kernel_name(e.key)
            by_kernel[name] += e.self_device_time_total / per_step
            launches[name] += e.count / args.steps
    by_category = collections.Counter()
    for name, ms in by_kernel.items():
        by_category[category(name)] += ms
    busy = sum(by_kernel.values())
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:args.top]
    report = {
        "workload": {k: v for k, v in vars(args).items() if k not in ("out", "trace_dir")},
        "card": card,
        "trace": trace,
        "wall_ms_per_step": wall,
        "wall_ms_per_frame_step": wall / args.frames,
        "host_ms_per_step_by_op": {e.key: e.self_cpu_time_total / per_step for e in host},
        "host_ms_per_step_by_stage": {e.key: e.cpu_time_total / per_step for e in events
                                      if e.key in STAGES or e.key == STEP},
    }
    if cuda:
        report.update({
            "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall,
            "launches_per_step": sum(launches.values()),
            "device_ms_per_step_by_kernel": dict(by_kernel.most_common(args.top)),
            "launches_per_step_by_kernel": {k: launches[k]
                                            for k, _ in by_kernel.most_common(args.top)},
            "device_ms_per_step_by_category": dict(by_category.most_common()),
        })
        print(f"device busy {busy:.3f} ms/step, idle share {1.0 - busy / wall:.3f}, "
              f"{sum(launches.values()):.0f} kernel launches/step", flush=True)
        print("\nper kernel (device ms/step, launches/step):")
        for name, ms in by_kernel.most_common(args.top):
            print(f"  {ms:8.4f} {launches[name]:6.0f}x  {name[:90]}")
        print("\nby category (device ms/step):")
        for name, ms in by_category.most_common():
            print(f"  {ms:8.4f}  {name}")
    print("\nby stage (host ms/step):")
    for name, ms in report["host_ms_per_step_by_stage"].items():
        print(f"  {ms:8.4f}  {name}")
    if not cuda:
        report["device_ms_per_step"] = "not measured"
        print("device times: not measured (cpu)\n\nper host op (host ms/step):")
        for name, ms in report["host_ms_per_step_by_op"].items():
            print(f"  {ms:8.4f}  {name[:90]}")
    bc.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
