"""Which stage of the port's step launches the device's work and leaves the
device idle: the program's stage spans joined with a ``torch.profiler``
trace of the step.

The port names each step's stages with ``record_function`` ranges while a
profiler is active (``vsrd_tpu_torch/utils/spans.py``); they share the
trace's clock with the device's operations. ``stages`` reads one profiled
chunk:

* each device operation goes to the innermost stage span, on any host
  thread, that is open when its launch call starts; the launch call is the
  host's runtime call with the operation's correlation id (so a kernel that
  autograd's device thread launches goes to ``vsrd.backward``, in which the
  main thread waits);
* each gap between the device's busy intervals goes to the innermost stage
  span open at the gap's middle;
* each host call that waits on the device (``SYNC_CALLS``) goes to the
  stage open when it starts.

Whatever falls inside a step (``vsrd.step``) but outside its stages is
counted under ``vsrd.step``, whatever falls outside every step under
``None``.

The readers of the stage metrics (``metrics/<kind>.<stage>.py``) find their
trace through ``traced``: a chunk of each phase, profiled after the run's
own traced chunks on the same card, at the run's configuration and frames,
from scenes and parameters drawn from ``SEED`` (the launches and shapes of a
step do not depend on the draw). Its launches are counted as they are,
beside the run's own ``launches``; its device ms and idle ms are split by
stage and scaled to the run's own totals, the device ms to ``kernel_busy_ms``
+ ``other_busy_ms`` and the idle ms to the total that ``idle_share`` uses, so
that only what falls outside every stage is missing from their sums. A
program without the stage spans gives no trace to read, and no stage metric.

The stage names are frozen here, as ``counts.py`` freezes the field work:
``tests/test_bench_stages.py`` holds them to the port's.
"""

from __future__ import annotations

import collections
import heapq
import importlib.util
import json
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.counts import mix
from benchmark.run import PHASES, optimization_config
from benchmark.trace import is_copy, merge, own_kernels, short_name

STEP = "vsrd.step"
STAGES = ("vsrd.boxes", "vsrd.rays", "vsrd.render", "vsrd.backward", "vsrd.adam",
          "vsrd.report")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
SEED = 2**31 + 1717
STEPS = 10          # steps profiled per phase, as the traffics' profile_steps


def innermost(spans, times) -> list:
    """For each of ``times``, the name of the latest-starting of ``spans``
    ((start, end, name), on any thread) open at it, or ``None``."""
    spans = sorted(spans)
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    live, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(live, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while live and live[0][1] < t:
            heapq.heappop(live)
        out[k] = live[0][2] if live else None
    return out


def stages(prof, steps: int, own: frozenset) -> dict | None:
    """One profiled chunk of ``steps`` steps by stage: per step the device
    kernels launched (copies and sets left out), the device ms of every
    operation launched and of the port's own kernels among them, and the
    host calls that wait on the device; the chunk's seconds of device idle
    time between busy intervals, in all and by stage. ``None`` where the
    trace holds no stage span."""
    spans, runtime, device, syncs = [], {}, [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((start, end, e.name, e.id))
        elif e.device_type == DeviceType.CPU:
            if e.name in STAGES or e.name == STEP:
                spans.append((start, end, e.name))
            elif e.name.startswith("cu"):
                runtime[e.id] = start
                if e.name in SYNC_CALLS:
                    syncs.append(start)
    if not any(name in STAGES for *_, name in spans):
        return None
    launched = innermost(spans, [runtime.get(cid, float("-inf")) for *_, cid in device])
    launches, busy, own_us = (collections.Counter() for _ in range(3))
    for (start, end, name, _), stage in zip(device, launched):
        busy[stage] += end - start
        if short_name(name) in own:
            own_us[stage] += end - start
        if not is_copy(name):
            launches[stage] += 1
    intervals = merge((s, e) for s, e, *_ in device)
    gaps = [((end + start) / 2, start - end) for (_, end), (start, _) in
            zip(intervals, intervals[1:])]
    idle = collections.Counter()
    for stage, (_, us) in zip(innermost(spans, [m for m, _ in gaps]), gaps):
        idle[stage] += us / 1e6
    waits = collections.Counter(innermost(spans, syncs))

    def per_step(counts, scale=1.0):
        return {k: v * scale / steps for k, v in counts.items()}

    return {
        "steps": steps,
        "launches": per_step(launches),
        "busy_ms": per_step(busy, 1e-3),
        "own_ms": per_step(own_us, 1e-3),
        "syncs": per_step(waits),
        "idle_s": dict(idle),
        "idle_total_s": sum(idle.values()),
    }


def profile_stages(config: dict, frames: int, device: str = "cuda") -> dict:
    """``stages`` of a chunk of ``STEPS`` steps of each phase on the card
    (``device``: a rehearsal on the CPU), each from its phase's start plus
    one (an unprofiled step first), so that no step computes the metrics,
    as in the run's own traced chunks."""
    import vsrd_tpu_torch
    from benchmark import params, scenes
    from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt

    made = scenes.make_scenes(SEED, frames, config, device)
    frame = fm.FrameData(**scenes.stack(made))
    initial = params.draw(SEED, made, config["optimization"], device)
    del made
    cfg = optimization_config(opt, config)
    optimizer = opt.Adam(cfg)
    own = own_kernels(Path(vsrd_tpu_torch.__file__).resolve().parent)
    out = {}
    for phase, begin in zip(PHASES, (0, cfg.warmup_steps)):
        state_params = opt.tree_map(torch.clone, initial)
        state = optimizer.init(state_params)
        opt.optimize_chunk(state_params, state, frame, SEED, begin, cfg, 1, optimizer)
        activities = [ProfilerActivity.CPU]
        if device == "cuda":
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            opt.optimize_chunk(state_params, state, frame, SEED, begin + 1, cfg, STEPS,
                               optimizer)
        out[phase] = stages(prof, STEPS, own)
        print(f"stages {phase}: {json.dumps(out[phase])}", file=sys.stderr, flush=True)
    return out


def traced(run: dict) -> dict | None:
    """Each phase's ``stages`` for the run (kept in the run's context, so
    that its readers share one trace), or ``None``: a run with no trace of
    its own, or a program without the stage spans."""
    if run["trace"] is None:
        return None
    if "stages" not in run:
        spans = importlib.util.find_spec("vsrd_tpu_torch.utils.spans")
        found = profile_stages(run["config"], run["frames"]) if spans else None
        run["stages"] = found if found and all(found.values()) else None
    return run["stages"]


def launches(run: dict, stage: str) -> float | None:
    found = traced(run)
    if found is None:
        return None
    return mix(*(found[p]["launches"].get(stage, 0.0) for p in PHASES))


def busy_ms(run: dict, stage: str) -> float | None:
    """The stage's share of the trace's device ms times the run's own
    traced device ms per step (``kernel_busy_ms`` + ``other_busy_ms``)."""
    found = traced(run)
    if found is None:
        return None
    per_phase = []
    for p in PHASES:
        own_trace, split = run["trace"][p], found[p]["busy_ms"]
        total = own_trace["own_ms"] + own_trace["other_ms"]
        per_phase.append(total * split.get(stage, 0.0) / sum(split.values()))
    return mix(*per_phase)


def idle_ms(run: dict, stage: str) -> float | None:
    """The stage's share of the trace's idle time times the idle ms per
    step that ``idle_share`` uses: the run's unprofiled host ms per step
    less its traced busy ms per step."""
    found = traced(run)
    if found is None:
        return None
    per_phase = []
    for p in PHASES:
        own_trace, total = run["trace"][p], found[p]["idle_total_s"]
        idle = run["step_ms"][p] - 1e3 * own_trace["busy_s"] / own_trace["steps"]
        per_phase.append(idle * found[p]["idle_s"].get(stage, 0.0) / total if total else 0.0)
    return mix(*per_phase)


def host_syncs(run: dict) -> float | None:
    """The step's waits on the device, in its stages: the profiler's own
    synchronization when it stops falls outside them."""
    found = traced(run)
    if found is None:
        return None
    return mix(*(sum(found[p]["syncs"].get(stage, 0.0) for stage in STAGES) for p in PHASES))
