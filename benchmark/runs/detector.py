"""Run module ``detector``: one run of a cell whose configuration names
``"run": "detector"``, the port's detector training step
(``models/detr3d.py::make_detector`` -> ``pipeline/detector_training.py::
create_train_state`` -> ``make_train_step``) at the configuration's widths,
on batches drawn on the card from the seed.

Set-up (``setup_s``, from the start of the process, as ``run.py`` took it
when it runs as the harness's ``__main__``, to the first timed step):

1. TF32 on for the program's convolutions and matmuls (the configuration's
   precision), the model from the seed (``make_detector(arch=...)``: its
   draw and the calibration of its frozen norms), its recipe held to the
   configuration's, the optimizer and the step;
2. the traffic's pool of batches on the card (``make_batches``);
3. the first ``check_steps`` steps from that draw through the window's own
   step with every dropout at 0, recording each step's loss and outputs on
   every decoder level, the first step's gradient as the clip got it
   (``tap_step``), the parameters before and after, and each JV solve's
   costs and assignments (``tap_matching``); then one step at the
   configuration's dropout, so that every kernel of the window has run.

The window runs ``chunk_steps`` steps a chunk, the pool cycled, each chunk
ending in its losses' copy to the host, until ``--seconds`` have passed.
``frame_s`` is all the chunks' seconds over all their steps over the batch:
the card's seconds per trained frame. Where the cell's end-to-end metrics
come from the device's trace (``busy_frame_s``, as ``run.py`` has it), every
chunk of the window runs under the profiler (device activity only) and
``busy_frame_s`` is the union of the device's operations in all of them
over all their steps over the batch: the device work a trained frame
costs. ``--trace 1`` runs the window unprofiled, then profiles
``profile_steps`` steps and reports the per-layer metrics (their readers'
``context``: ``config``, ``trace`` (``trace.summarize``), ``stages`` (the
device ms, launches, idle ms and waits on the device by the step's
``det.*`` span, ``stage_split``), ``step_ms``, ``frame_s``, ``flops`` and
``jv_bytes`` (``detr_counts.py``)), the device's busy seconds in the
profiled steps and the breakdown.

After the window: the device's peak memory, the program freed, then
``correct``: the plain reference (``detr_reference.py``, float32 with TF32
off) follows the checked steps from the program's initial state, batches
and assignments; ``check.phase_readings`` makes ``loss_first``, ``loss``,
``grad`` and ``change`` of the two (one "frame": the batch); ``output``
holds the first step's 2D boxes elementwise (``output_gaps``),
``grad_outputs`` the first loss's gradient with respect to each image's
logits (``output_grad_gaps``); and from the reference's own matching cost
of each checked step (``detr_reference.matching_cost``, float64, on the
program's recorded outputs and the batch), ``cost`` holds the program's
costs elementwise (``cost_gap``) and ``match`` each of the program's
assignments to scipy's optimum on the reference's cost
(``detr_reference.hungarian_gap``).

``python3 benchmark/runs/detector.py --seeds ...`` prints the readings that
the cell's limits come from (``readings``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from benchmark import check, detr_counts, detr_reference, run  # noqa: E402

NUMBERS = ("loss_first", "loss", "grad", "change", "output", "grad_outputs", "cost", "match")
OUTPUTS = detr_reference.OUTPUTS
STEP = "det.step"
STAGES = ("det.backbone", "det.transformer", "det.match", "det.loss", "det.backward",
          "det.optim")
# KITTI-360's rectified perspective camera (image_00) at 1408 x 376
FOCAL, CENTER = 552.554261, (682.049453, 238.769549)
NATIVE_SIZE = (376, 1408)


def process_start() -> float:
    """The process's start on the host clock: ``run.py``'s ``START`` as the
    harness's ``__main__`` took it (this module's ``run`` is a second copy,
    imported later), or, in a rehearsal, the imported ``run``'s."""
    return getattr(sys.modules.get("__main__"), "START", run.START)


def named_files(spec: dict, root: Path = run.ROOT) -> list[Path]:
    """The files a run of this module reads by name, beside the cell's
    configuration, traffic and limits."""
    bench = root / "benchmark"
    return [bench / "detr_reference.py", bench / "detr_counts.py", bench / "check.py",
            bench / "trace.py", bench / "stages.py",
            *(bench / "metrics" / f"{name}.py" for name in spec["per_layer"])]


def derived_seed(seed: int, tag: int) -> int:
    import numpy as np
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1)[0] >> 1)


def make_batches(seed: int, config: dict, traffic: dict, device) -> list:
    """``batch_pool`` batches of the configuration's batch on ``device``
    from the seed: uniform images, K of KITTI-360's camera scaled to the
    image, and per image a count of cars in the traffic's ``boxes`` range,
    each a 3D box in the camera frame (centre 5-60 m ahead, within the
    view, on the road; car-sized; any yaw) and its projection's bounds as a
    normalized 2D box, padded to ``max_boxes``."""
    import torch
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 0xDE7))
    b, n = config["batch"], config["max_boxes"]
    height, width = config["image_size"]
    scale = torch.tensor([width / NATIVE_SIZE[1], height / NATIVE_SIZE[0], 1.0], device=device)
    k = torch.tensor([[FOCAL, 0.0, CENTER[0]], [0.0, FOCAL, CENTER[1]], [0.0, 0.0, 1.0]],
                     device=device) * scale[:, None]
    unit = torch.tensor(detr_reference.UNIT_CORNERS, dtype=torch.float32, device=device)
    lo, hi = traffic["boxes"]

    def uniform(low, high, *shape):
        return low + (high - low) * torch.rand(*shape, generator=g, device=device)

    out = []
    for _ in range(traffic["batch_pool"]):
        count = torch.randint(min(lo, n), min(hi, n) + 1, (b, 1), generator=g, device=device)
        z = uniform(5.0, 60.0, b, n)
        location = torch.stack([uniform(-0.6, 0.6, b, n) * z, uniform(1.0, 2.0, b, n), z], -1)
        half = torch.stack([uniform(0.75, 1.0, b, n), uniform(0.7, 0.85, b, n),
                            uniform(1.8, 2.4, b, n)], -1)
        yaw = uniform(-math.pi, math.pi, b, n)
        cos, sin = torch.cos(yaw), torch.sin(yaw)
        zero, one = torch.zeros_like(cos), torch.ones_like(cos)
        rotation = torch.stack([torch.stack([cos, zero, sin], -1),
                                torch.stack([zero, one, zero], -1),
                                torch.stack([-sin, zero, cos], -1)], -2)
        corners = (unit * half[..., None, :]) @ rotation.transpose(-2, -1) + location[..., None, :]
        pixels = corners @ k.t()
        pixels = pixels[..., :2] / pixels[..., 2:]
        size = torch.tensor([width, height], device=device, dtype=torch.float32)
        lower = (pixels.amin(-2) / size).clamp(0.0, 1.0)
        upper = (pixels.amax(-2) / size).clamp(0.0, 1.0)
        out.append({
            "images": torch.rand(b, height, width, 3, generator=g, device=device),
            "intrinsics": k.expand(b, 3, 3).contiguous(),
            "labels": torch.zeros(b, n, dtype=torch.int32, device=device),
            "boxes_2d": torch.cat([lower, upper], -1),
            "boxes_3d": corners,
            "valid": torch.arange(n, device=device)[None] < count,
        })
    return out


def merged(spec: dict, sizes: dict | None) -> tuple[dict, dict]:
    """The configuration and the traffic with a rehearsal's ``sizes`` over
    them (its ``traffic`` key over the traffic)."""
    sizes = dict(sizes or {})
    traffic = {**spec["traffic"], **sizes.pop("traffic", {})}
    return {**spec["config"], **sizes}, traffic


def recipe_of(config: dict) -> dict:
    """The training recipe the configuration states, in the model's terms."""
    opt, loss, matcher = config["optimizer"], config["loss"], config["matcher"]
    return {"backbone_lr": opt["lr_backbone"], "max_norm": opt["clip_max_norm"],
            "aux_loss": config["aux_loss"], "giou": loss["giou"] > 0 and matcher["giou"] > 0,
            "no_object_weight": loss["no_object_weight"]}


# the loss's and the matcher's weights and the matcher's pad in detr3d.detr_loss and
# matching_cost
FIXED_WEIGHTS = {"loss": {"class": 1.0, "l1": 5.0, "giou": 2.0, "box3d": 1.0},
                 "matcher": {"class": 1.0, "l1": 5.0, "giou": 2.0, "pad": 0.0}}


class Cell:
    """A run after its set-up: the program's objects and the checked
    steps' record."""


def build(config: dict, seed: int, device: str):
    """The model, optimizer and step of the configuration, checked against
    it."""
    import dataclasses
    from vsrd_tpu_torch.models import detr3d
    from vsrd_tpu_torch.pipeline import detector_training as dt
    model = detr3d.make_detector(
        arch=config["arch"], seed=derived_seed(seed, 0x3E7), device=device,
        num_classes=config["num_classes"], num_queries=config["num_queries"],
        hidden_dim=config["hidden_dim"], num_encoder_layers=config["num_encoder_layers"],
        num_decoder_layers=config["num_decoder_layers"], num_heads=config["num_heads"],
        mlp_dim=config["mlp_dim"], dropout=config["dropout"])
    stated = recipe_of(config)
    held = dataclasses.asdict(model.recipe)
    if held != stated:
        raise run.RunError(f"the model's recipe {held} is not the configuration's {stated}")
    for part, weights in FIXED_WEIGHTS.items():
        if {k: config[part][k] for k in weights} != weights:
            raise run.RunError(f"the port's {part} weights are {weights}, the configuration "
                               f"states {config[part]}")
    model, optimizer = dt.create_train_state(model, config["optimizer"]["lr"], device)
    return model, optimizer, dt.make_train_step(model, optimizer, config["num_classes"])


@contextlib.contextmanager
def tap_matching():
    """Every JV solve's costs and assignments while open (the loss's one
    call of ``ops/matching.py::linear_sum_assignment`` a step)."""
    from vsrd_tpu_torch.ops import matching
    solve = matching.linear_sum_assignment
    calls = []

    def recorded(costs):
        out = solve(costs)
        calls.append((costs.detach().clone(), out.detach().clone()))
        return out

    matching.linear_sum_assignment = recorded
    try:
        yield calls
    finally:
        matching.linear_sum_assignment = solve


@contextlib.contextmanager
def tap_step(model):
    """Every forward's outputs on every decoder level (per forward, in the
    model's order: the last level, then the earlier ones), the first
    backward's gradient with respect to the first forward's outputs (the
    same order), and the first gradient as ``clip_grad_norm_`` got it (by
    parameter), while open."""
    import torch
    clip = torch.nn.utils.clip_grad_norm_
    seen = {"outputs": [], "output_grads": []}

    def keep(level, key):
        def hook(grad):
            seen["output_grads"][level][key] = grad.detach().clone()
        return hook

    def outputs(module, args, kwargs, out):
        levels = [out] + out.get("aux_outputs", [])
        seen["outputs"].append([{k: level[k].detach().clone() for k in OUTPUTS}
                                for level in levels])
        if len(seen["outputs"]) == 1:
            for index, level in enumerate(levels):
                seen["output_grads"].append({})
                for k in OUTPUTS:
                    if level[k].requires_grad:
                        level[k].register_hook(keep(index, k))

    def clipped(params, *args, **kwargs):
        params = list(params)
        if "grads" not in seen:
            seen["grads"] = {id(p): p.grad.detach().clone() for p in params}
        return clip(params, *args, **kwargs)

    hook = model.register_forward_hook(outputs, with_kwargs=True)
    torch.nn.utils.clip_grad_norm_ = clipped
    try:
        yield seen
    finally:
        hook.remove()
        torch.nn.utils.clip_grad_norm_ = clip


def prepare(workload: str, seed: int, device: str = "cuda", sizes: dict | None = None,
            root: Path = run.ROOT, profiled: bool = False) -> Cell:
    """Set-up (see the module docstring). ``profiled``: the window will run
    under the profiler, so the step at the window's dropout runs under it
    too (its start-up is set-up's)."""
    import torch
    from vsrd_tpu_torch.models import detr3d

    c = Cell()
    c.spec = run.load_spec(workload, root)
    c.config, c.traffic = merged(c.spec, sizes)
    c.device, c.cuda = device, device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    c.model, c.optimizer, c.step = build(c.config, seed, device)
    c.batches = make_batches(seed, c.config, c.traffic, device)
    c.trained = [name for name, p in c.model.named_parameters() if p.requires_grad]
    params = dict(c.model.named_parameters())
    state = {k: v.detach().clone() for k, v in c.model.state_dict().items()}
    steps = c.traffic["check_steps"]
    detr3d.set_dropout(c.model, 0.0)
    losses = []
    with tap_matching() as calls, tap_step(c.model) as first:
        for k in range(steps):
            loss, _ = c.step(c.batches[k % len(c.batches)])
            losses.append(loss)
    detr3d.set_dropout(c.model, c.config["dropout"])
    if "grads" not in first:
        raise run.RunError("the step never clipped its gradient: not the configuration's recipe")
    levels = first["outputs"][0] if first["outputs"] else []
    output_grads = first["output_grads"]
    c.record = {
        "losses": [[float(x)] for x in losses],
        "first_grads": [[first["grads"][id(params[name])] for name in c.trained]],
        "outputs": levels[1:] + levels[:1],            # first decoder level first
        "output_grads": output_grads[1:] + output_grads[:1],
        "step_outputs": first["outputs"],              # per step, the model's order
        "params": [[params[name].detach().clone() for name in c.trained]],
        "initial": [[state[name] for name in c.trained]],
        "state": state,
        "solves": calls,
    }
    c.index = steps
    with run.device_profiler(profiled and c.cuda) as prof:
        c.step(c.batches[c.index % len(c.batches)])  # the window's dropout, once
    if prof is not None:
        from benchmark import trace as tr
        tr.device_busy_s(prof)
    c.index += 1
    if c.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    return c


def run_chunk(c: Cell, steps: int):
    """``steps`` steps of the pool in turn, ending in the losses' copy to
    the host; returns (seconds, losses)."""
    import torch
    begin = time.perf_counter()
    losses = []
    for _ in range(steps):
        losses.append(c.step(c.batches[c.index % len(c.batches)])[0])
        c.index += 1
    values = torch.stack(losses).cpu()
    return time.perf_counter() - begin, values


def measure(c: Cell, seconds: float, profiled: bool = False) -> dict:
    """The window: chunks until ``seconds`` have passed. With ``profiled``
    every chunk runs under the profiler (device activity only), and
    ``busy_s`` is the device's busy seconds per step: the union of its
    operations in all of the chunks over all of their steps."""
    import torch
    from benchmark import trace as tr
    chunk = c.traffic["chunk_steps"]
    chunks, attempted, failed, busy = [], 0, 0, 0.0
    start = time.perf_counter()
    while True:
        with run.device_profiler(profiled) as prof:
            elapsed, losses = run_chunk(c, chunk)
        if prof is not None:
            busy += tr.device_busy_s(prof)
        chunks.append(elapsed)
        attempted += chunk
        failed += int((~torch.isfinite(losses)).sum())
        if time.perf_counter() - start >= seconds:
            break
    steps = chunk * len(chunks)
    return {"step_s": sum(chunks) / steps, "busy_s": busy / steps if profiled else None,
            "chunks": chunks, "attempted": attempted, "failed": failed}


def stage_split(prof, steps: int) -> dict | None:
    """The profiled steps by the step's ``det.*`` stage (frozen in
    ``STAGES``), as ``stages.stages`` splits the frame cells' steps: per
    step the device ms and the kernels (copies and sets left out) launched
    from each, a device operation going to the innermost stage open on any
    host thread when its launch call starts (``stages.innermost``;
    autograd's device thread launches inside ``det.backward``, in which the
    main thread waits); the device's idle ms, each gap between busy
    intervals going to the innermost stage open at its middle; and the host
    calls that wait on the device (``stages.SYNC_CALLS``), each to the stage
    open when it starts. ``None`` where the trace holds no stage span."""
    from torch.autograd import DeviceType
    from benchmark.stages import SYNC_CALLS, innermost
    from benchmark.trace import is_copy, merge
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
    busy, launches, idle = collections.Counter(), collections.Counter(), collections.Counter()
    for (start, end, name, _), stage in zip(device, launched):
        busy[stage] += end - start
        if not is_copy(name):
            launches[stage] += 1
    intervals = merge((s, e) for s, e, *_ in device)
    gaps = [((end + start) / 2, start - end)
            for (_, end), (start, _) in zip(intervals, intervals[1:])]
    for stage, (_, us) in zip(innermost(spans, [m for m, _ in gaps]), gaps):
        idle[stage] += us
    waits = collections.Counter(innermost(spans, syncs))
    return {"busy_ms": {k: v / 1e3 / steps for k, v in busy.items()},
            "launches": {k: v / steps for k, v in launches.items()},
            "idle_ms": {k: v / 1e3 / steps for k, v in idle.items()},
            "syncs": {k: v / steps for k, v in waits.items()}}


def profile_steps(c: Cell) -> tuple[dict, dict | None]:
    """``profile_steps`` steps under ``torch.profiler``: the trace's summary
    and its split by stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace as tr
    steps = c.traffic["profile_steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        elapsed, _ = run_chunk(c, steps)
    own = tr.own_kernels(Path(sys.modules["vsrd_tpu_torch"].__file__).resolve().parent)
    return tr.summarize(prof, steps, own, elapsed), stage_split(prof, steps)


def free_program(c: Cell) -> None:
    import torch
    del c.model, c.optimizer, c.step
    gc.collect()
    if c.cuda:
        torch.cuda.empty_cache()


def reference_inputs(c: Cell) -> dict:
    """What the reference follows: the initial state, the trained names,
    the checked steps' batches, and each step's assignments in the
    reference's level order (first decoder level first; ``detr_loss``
    solves the last level first, then the earlier ones in order)."""
    levels = c.config["num_decoder_layers"]
    assignments = []
    for _, row_to_col in c.record["solves"]:
        per_level = list(row_to_col.reshape(levels, -1, row_to_col.shape[-1]).unbind(0))
        assignments.append(per_level[1:] + per_level[:1])
    steps = len(c.record["losses"])
    return {"initial": c.record["state"], "trained": c.trained,
            "batches": [c.batches[k % len(c.batches)] for k in range(steps)],
            "assignments": assignments}


def follow_reference(c: Cell, autocast_dtype=None) -> dict:
    inputs = reference_inputs(c)
    return detr_reference.follow(inputs["initial"], inputs["trained"], inputs["batches"],
                                 inputs["assignments"], c.config, autocast_dtype)


def reference_costs(c: Cell) -> list | None:
    """The reference's matching cost of each checked step (``detr_reference.
    matching_cost`` on the step's recorded outputs and its batch, the levels
    in ``detr_loss``'s order), or ``None`` where the program recorded no
    solve or no outputs for a step."""
    import torch
    steps = len(c.record["losses"])
    if len(c.record["solves"]) != steps or len(c.record["step_outputs"]) != steps:
        return None
    return [torch.cat([detr_reference.matching_cost(level, c.batches[k % len(c.batches)],
                                                    c.config) for level in levels])
            for k, levels in enumerate(c.record["step_outputs"])]


def cost_gap(c: Cell, costs: list | None) -> float:
    """``cost``: the widest of every checked step's ``detr_reference.
    cost_gap`` of the program's costs against the reference's ``costs``."""
    if costs is None:
        return math.inf
    return max(detr_reference.cost_gap(program, reference)
               for (program, _), reference in zip(c.record["solves"], costs))


def match_gap(c: Cell, costs: list | None) -> float:
    """``match``: the worst of every checked step's ``hungarian_gap`` of the
    program's assignment on the reference's ``costs``."""
    if costs is None:
        return math.inf
    return max(detr_reference.hungarian_gap(cost, row_to_col,
                                            c.batches[k % len(c.batches)]["valid"])
               for k, ((_, row_to_col), cost) in enumerate(zip(c.record["solves"], costs)))


def output_gaps(program: list, reference: list) -> dict:
    """The first step's outputs on every decoder level against the
    reference's: for each of the logits, the 2D boxes and the 3D corners the
    summed absolute gap over the reference's summed absolute values
    (``output_<key>``), and ``output``, the 2D boxes' (infinite where the
    program recorded none). The others are not compared: across seeds the
    logits' reading swings seven times over and the 3D corners' meets the
    control's (a corner's yaw is the head's raw (cos, sin) pair over its
    length, which multiplies the pair's rounding where the pair is short)."""
    if len(program) != len(reference) or not program:
        return {"output": math.inf, **{f"output_{k}": math.inf for k in OUTPUTS}}
    out = {}
    for key in OUTPUTS:
        gap = sum(float((p[key] - r[key]).abs().sum()) for p, r in zip(program, reference))
        scale = sum(float(r[key].abs().sum()) for r in reference)
        out[f"output_{key}"] = gap / scale if scale > 0.0 else math.inf
    out["output"] = out["output_boxes_2d"]
    return out


def output_grad_gaps(program: list, reference: list) -> dict:
    """The first loss's gradient with respect to the model's outputs image by
    image: per image and output (the logits, the 2D boxes, the 3D corners)
    the summed absolute gap over every level over the reference's summed
    absolute values there; per output the widest image
    (``grad_outputs_<key>``), and ``grad_outputs``, the logits' (infinite
    where the program recorded none). It holds each image's own terms of the
    loss, where the loss and the parameters' gradients sum over images that
    look alike at the random init. The class terms' gradient is smooth in
    the logits; the boxes' passes through L1's signs and GIoU's corners."""
    if len(program) != len(reference) or not program or any(
            set(p) != set(OUTPUTS) for p in program):
        return {"grad_outputs": math.inf, **{f"grad_outputs_{k}": math.inf for k in OUTPUTS}}
    out = {}
    for key in OUTPUTS:
        worst = 0.0
        for b in range(reference[0][key].shape[0]):
            gap = sum(float((p[key][b].double() - r[key][b].double()).abs().sum())
                      for p, r in zip(program, reference))
            scale = sum(float(r[key][b].double().abs().sum()) for r in reference)
            worst = max(worst, gap / scale if scale > 0.0 else math.inf)
        out[f"grad_outputs_{key}"] = worst
    out["grad_outputs"] = out["grad_outputs_logits"]
    return out


def readings_of(c: Cell, followed: dict, program: dict | None = None) -> dict:
    """Every candidate reading of the program's record (or ``program``, the
    control's, which has no matching of its own: ``cost`` and ``match`` 0)
    against the reference's: ``check.phase_readings``' (each number's median
    and worst leaf), ``output_gaps``, ``output_grad_gaps``, ``cost`` and
    ``match``."""
    program = program or c.record
    readings = check.phase_readings(program, {**followed, "initial": c.record["initial"]})
    readings.update(output_gaps(program["outputs"], followed["outputs"]))
    readings.update(output_grad_gaps(program["output_grads"], followed["output_grads"]))
    costs = reference_costs(c) if program is c.record else None
    readings["cost"] = cost_gap(c, costs) if program is c.record else 0.0
    readings["match"] = match_gap(c, costs) if program is c.record else 0.0
    return readings


def numbers(c: Cell, followed: dict, program: dict | None = None) -> dict:
    """Every compared number of the program's record (or ``program``, the
    control's) against the reference's."""
    readings = readings_of(c, followed, program)
    return {k: readings[k] for k in NUMBERS}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: dict | None = None, root: Path = run.ROOT):
    """One run of ``workload`` (see the module docstring); returns the
    result, its compared numbers last, and the chunks' seconds."""
    import torch
    profiled = device == "cuda" and not trace and run.profiled_window(run.load_spec(workload,
                                                                                    root))
    c = prepare(workload, seed, device, sizes, root, profiled)
    setup_s = time.perf_counter() - process_start()
    window = measure(c, seconds, profiled)
    batch = c.config["batch"]
    frame_s = window["step_s"] / batch
    summary, split = profile_steps(c) if trace and c.cuda else (None, None)
    memory_peak = torch.cuda.max_memory_allocated() if c.cuda else 0
    free_program(c)

    values = numbers(c, follow_reference(c))
    limits = c.spec["limits"]
    compared = [k for k in NUMBERS if limits.get(k) is not None]
    correct = window["failed"] == 0 and all(
        math.isfinite(values[k]) and values[k] <= limits[k] for k in compared)

    if trace:
        context = {"config": c.config, "trace": summary, "stages": split,
                   "step_ms": 1e3 * window["step_s"], "frame_s": frame_s,
                   "flops": detr_counts.step_flops(c.config),
                   "jv_bytes": detr_counts.jv_bytes(c.config)}
        metrics = {}
        for name, metric in c.spec["per_layer"].items():
            value = run.read_metric(name, context)
            if value is not None:
                metrics[name] = {"value": value, "unit": metric["unit"]}
    else:
        own = {"frame_s": frame_s, "setup_s": setup_s}
        if window["busy_s"] is not None:
            own["busy_frame_s"] = window["busy_s"] / batch
        metrics = {m["name"]: {"value": own[m["name"]], "unit": m["unit"]}
                   for m in c.spec["end_to_end"] if m["name"] in own}
    result = {
        "correct": bool(correct),
        "attempted": window["attempted"] * batch,
        "failed": window["failed"] * batch,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if c.cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if c.cuda else "cpu",
            "count": c.spec["cell"]["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if summary is not None:
        from benchmark import trace as tr
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["wall_s"]
        result["breakdown"] = tr.breakdown([summary])
        print(f"stages: {json.dumps(split)}", file=sys.stderr)
    result["checks"] = {k: {"value": values[k], "limit": limits.get(k)} for k in NUMBERS}
    json.dumps(result)
    return result, {"step": window["chunks"]}


# ---------------------------------------------------------------------------
# readings for the limits
# ---------------------------------------------------------------------------

def _sliced(tree, half: int):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree[:half]
    if isinstance(tree, dict):
        return {k: _sliced(v, half) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sliced(v, half) for v in tree]
    return tree


@contextlib.contextmanager
def half_batch():
    """Every level's loss over the first half of the batch alone (the
    matching still over all of it)."""
    from vsrd_tpu_torch.models import detr3d
    level_loss = detr3d._single_level_loss

    def half(outputs, row_to_col, *targets_and_options):
        keep = row_to_col.shape[0] // 2
        targets, options = targets_and_options[:4], targets_and_options[4:]
        return level_loss(_sliced(outputs, keep), row_to_col[:keep],
                          *(t[:keep] for t in targets), *options)

    detr3d._single_level_loss = half
    try:
        yield
    finally:
        detr3d._single_level_loss = level_loss


@contextlib.contextmanager
def unchanged_state():
    """Every AdamW step a no-op."""
    import torch
    step = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.AdamW.step = step


@contextlib.contextmanager
def identity_match():
    """Every JV solve answered by the identity (query i to slot i)."""
    import torch
    from vsrd_tpu_torch.ops import matching
    solve = matching.linear_sum_assignment
    matching.linear_sum_assignment = lambda costs: torch.arange(
        costs.shape[-1], device=costs.device).expand(costs.shape[:-1]).contiguous()
    try:
        yield
    finally:
        matching.linear_sum_assignment = solve


@contextlib.contextmanager
def giou_off_cost():
    """The matching cost without its GIoU term (the loss keeps its own)."""
    import torch
    from vsrd_tpu_torch.ops import iou2d
    pairwise = iou2d.generalized_box_iou
    iou2d.generalized_box_iou = lambda a, b: torch.zeros(
        (*a.shape[:-1], b.shape[-2]), dtype=a.dtype, device=a.device)
    try:
        yield
    finally:
        iou2d.generalized_box_iou = pairwise


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state,
          "identity_match": identity_match, "giou_off_cost": giou_off_cost}


def read_seed(workload: str, seed: int, device: str, sizes: dict | None, control: bool,
              faults) -> dict:
    """One seed's readings (``readings_of``): sound, and the bf16 control's
    and each fault's when asked (a fault's reference follows the faulty
    run's own record)."""
    import torch
    out = {"seed": seed}
    begin = time.perf_counter()
    c = prepare(workload, seed, device, sizes)
    free_program(c)
    followed = follow_reference(c)
    out["sound"] = readings_of(c, followed)
    out["seconds"] = time.perf_counter() - begin
    if control:
        lower = follow_reference(c, torch.bfloat16)
        out["control"] = readings_of(c, followed, {**lower, "initial": c.record["initial"]})
    del c
    for name in faults:
        with FAULTS[name]():
            faulty = prepare(workload, seed, device, sizes)
        free_program(faulty)
        out[name] = readings_of(faulty, follow_reference(faulty))
        del faulty
    gc.unfreeze()
    return out


def readings(argv=None) -> None:
    """Readings for the cell's limits on the card, one JSON line a seed and
    a summary (the largest sound reading, the smallest control and fault
    readings of each number)::

        python3 benchmark/runs/detector.py --seeds 11 12 13 --control-seeds 11 \\
            --fault-seeds 12
    """
    parser = argparse.ArgumentParser(description=readings.__doc__.splitlines()[0])
    parser.add_argument("--workload", default="detr-r50-b8")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    print(f"card: {run.card_label()}", file=sys.stderr, flush=True)
    lines = []
    for seed in args.seeds:
        line = read_seed(args.workload, seed, args.device, None, seed in args.control_seeds,
                         tuple(FAULTS) if seed in args.fault_seeds else ())
        lines.append(line)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    keys = lines[0]["sound"]
    summary = {"sound_max": {k: max(line["sound"][k] for line in lines) for k in keys}}
    for kind in ("control", *FAULTS):
        read = [line[kind] for line in lines if kind in line]
        if read:
            summary[f"{kind}_min"] = {k: min(r[k] for r in read) for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    readings()
