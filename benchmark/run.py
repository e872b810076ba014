"""One run of one cell of the benchmark of ``vsrd_tpu_torch``, the PyTorch and
CUDA port, on one card::

    python3 benchmark/run.py --workload b8-f1 --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` names the cell's configuration (``benchmark/configs/``)
and traffic (``benchmark/traffic/<name>.json``); ``benchmark/checks/<cell>.json``
holds the limits of the comparison that decides ``correct``, and each
per-layer metric is read by ``benchmark/metrics/<name>.py``.

Set-up (``setup_s``, from the start of this process to the first timed
step): the scenes on the card from ``--seed`` (``scenes.py``), the port's
``FrameData``, the initial parameters (``params.py``), then the first three
steps of each phase through the window's own call, ``optimize_chunk`` (the
residual phase from step 1000, both from the initial draw, each with its own
Adam state), whose losses, first gradient and parameter change the
reference checks after the window, as it checks the field kernels' own
outputs and cotangents in the residual phase's first step (``tap.py``); the
traffic's further first steps of a
phase (``gradient_probes``: the same first step from the initial draw at
later step indices, so with other draws) on copies; and one step of each
phase at a metric step on copies, so that every shape of the window has run.
The device's peak memory is counted from the end of set-up.

The window runs chunks of 50 steps (the recipe's metric interval) in the
cycle warmup, residual, residual (the recipe's 1000 : 2000 steps), each
phase continuing its own state and wrapping to its start at its end, until
``--seconds`` have passed and one cycle is whole. ``frame_s`` is (1000 x the
warmup's seconds per step + 2000 x the residual's) / F, each phase's seconds
per step being all of its chunks' time over all of its steps.

``--trace 1`` then runs a short chunk of each phase under
``torch.profiler`` (events kept in memory) and reports the per-layer
metrics, the device's busy seconds in the traced chunks and the breakdown
instead of the end-to-end metrics.

After the window the device's peak memory is read, the program's state is
freed and the plain reference (``reference.py``) follows the checked steps
frame by frame; ``check.py`` turns both into the numbers held against the
limits. The last lines of standard error give each number and its limit;
the last line of standard output is the result.

The run fails (no result) without a CUDA card, with fewer cards than the
cell asks for, without the port beside this folder, or when JAX, flax or
the JAX package has been imported.

**A cell of another kind: the run-module contract.** A configuration file
that carries ``"run": "<name>"`` is run by ``benchmark/runs/<name>.py``
(found under the run's root, loaded by path) instead of the frame
optimization above; everything else in this file stays as it is. So a later
model or path comes in as new files alone: its configuration (with
``"run"``), its traffic (``traffic/<name>.json``, whatever keys its module
reads), its limits (``checks/<cell>.json``), its run module, its plain
reference beside ``reference.py`` and its metric readers, plus entries in
``BENCHMARK.json``. ``runs/drive.py`` is the worked example. The module
defines:

* ``run_cell(workload, seed, seconds, trace, device, sizes, root)``, which
  returns ``(result, chunks)`` as ``run_cell`` below does. ``result`` has
  the keys ``correct`` (bool), ``attempted`` and ``failed`` (counts of the
  window's work), ``metrics`` (``{name: {"value", "unit"}}``: with ``trace``
  false the cell's end-to-end metrics that it measured, ``setup_s`` among
  them, and with ``trace`` true its per-layer metrics, each read by
  ``read_metric(name, context)``), ``device`` (``platform``, ``kind``,
  ``count``, ``memory_peak_bytes``, and with ``trace`` on the card
  ``busy_s`` and ``window_s``), optionally ``breakdown``
  (``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``, at
  most 10 entries each, ``trace.breakdown``) and, last, ``checks``
  (``{number: {"value", "limit"}}``, every number compared). ``chunks``
  maps a name to a list of seconds that ``main`` prints on standard error;
  ``device`` is ``"cuda"`` on the card and ``"cpu"`` in a rehearsal, where
  ``sizes`` overrides configuration keys. ``setup_s`` counts from the
  process's start, ``START`` of ``__main__`` where that is this file (the
  module's own ``from benchmark import run`` loads a second copy, later);
* ``NUMBERS``: the names of the numbers that its ``checks`` may compare,
  each of which its cell's limits file holds;
* ``named_files(spec, root)``: the files it reads by name besides the
  cell's configuration, traffic and limits (``tests/test_bench_rehearsal.py``
  holds them present).

``main`` does the rest for every cell: the card's presence and count before
the run, the chunks on standard error, the check that no JAX module was
imported, each compared number beside its limit as the last lines of
standard error and the result as the last line of standard output.

The per-layer readers (``metrics/<name>.py``, ``read(context)``, returning
``None`` where the run holds nothing to read) get the run module's own
``context``. Here it has ``config`` (the configuration as run), ``frames``,
``trace`` (per phase, the profiled chunk's summary, ``trace.summarize``;
``None`` untraced or without a card), ``step_ms`` (per phase) and
``frame_s``; ``runs/drive.py`` passes ``config``, ``trace`` and ``drive``.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))   # the port and this folder's modules, from the checkout
PACKAGE = "vsrd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "vsrd_tpu")
PHASES = ("warmup", "residual")


class RunError(Exception):
    """A run that cannot give a result."""


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for PyTorch's CPU operations (the step's host work is
    one thread's dispatch; a pool of spinning workers only adds noise)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = root / "build"
    os.environ["VSRD_TORCH_BUILD_DIR"] = str(build / "vsrd_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of JAX, flax or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload``: its entry, configuration, traffic, limits and
    the readers of its per-layer metrics, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    readers = {}
    for metric in bench["per_layer"]:
        if workload in metric.get("workloads", [workload]):
            readers[metric["name"]] = metric
    return {
        "cell": cell,
        "config": load_json(root / config["file"]),
        "traffic": load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "benchmark" / "checks" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": readers,
    }


def read_metric(name: str, context: dict):
    from benchmark.readers import reader
    return reader(name)(context)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def optimization_config(opt, config: dict):
    """The port's ``OptimizationConfig`` for the configuration."""
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["optimization"].items()}
    return opt.OptimizationConfig(**fields)


def recipe_of(config: dict) -> dict:
    """The configuration as the reference reads it."""
    o = config["optimization"]
    return {
        "num_steps": o["num_steps"], "warmup_steps": o["warmup_steps"],
        "num_rays": o["num_rays"], "num_samples": o["num_samples"],
        "distance_range": tuple(o["distance_range"]),
        "temperature": (o["max_sdf_union_temperature"], o["min_sdf_union_temperature"]),
        "std": (o["max_sdf_std_deviation"], o["min_sdf_std_deviation"]),
        "loss_weights": {"iou_projection": o["iou_projection_weight"],
                         "l1_projection": o["l1_projection_weight"],
                         "silhouette": o["silhouette_weight"],
                         "eikonal": o["eikonal_weight"]},
        "box_lr": o["box_lr"], "embedding_lr": o["embedding_lr"],
        "hypernetwork_lr": o["hypernetwork_lr"], "lr_decay": o["lr_decay"],
    }


def per_frame_s(cfg, per_step: dict, frames: int) -> float:
    """Seconds per frame at the full recipe from seconds per step by phase:
    (warmup steps x the warmup's + residual steps x the residual's) / F."""
    return (cfg.warmup_steps * per_step["warmup"]
            + (cfg.num_steps - cfg.warmup_steps) * per_step["residual"]) / frames


def profiled_window(cell: dict) -> bool:
    """Whether the cell's untraced window runs under the profiler: where an
    end-to-end metric comes from the device's trace."""
    return any(m["source"] == "device_trace" for m in cell["end_to_end"])


def device_profiler(on: bool):
    """``torch.profiler`` over the device's activity alone, or nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def frames_of(stacked: dict, frames: int) -> list:
    """Per-frame views of the stacked scene tensors (the reference's input)."""
    if frames == 1:
        return [stacked]
    return [{k: (v if k == "image_size" else int(v[f]) if k == "target_index" else v[f])
             for k, v in stacked.items()} for f in range(frames)]


def per_frame(leaves, frames: int) -> list:
    """Leaves with a leading frame axis (or none, for one frame) -> per frame."""
    if frames == 1:
        return [list(leaves)]
    return [[t[f] for t in leaves] for f in range(frames)]


class Phase:
    """One phase's parameters, Adam state and next step."""

    def __init__(self, name, params, opt_state, begin, end):
        self.name, self.params, self.opt_state = name, params, opt_state
        self.begin, self.end, self.step = begin, end, begin


def checked_steps(opt, phase: Phase, frame, stream: int, cfg, optimizer, steps: int,
                  frames: int) -> dict:
    """The phase's first ``steps`` steps through ``optimize_chunk``: the
    losses, the first gradient as Adam got it, the parameters before and
    after, and the steps' stream seeds; once the residual field is on, also
    the first step's field call (``tap.field_calls``, per frame; ``None``
    where the step made no single such call)."""
    from benchmark import tap
    from vsrd_tpu_torch.rendering import field_kernels
    leaves = lambda tree: [t for _, t in opt.tree_leaves(tree)]  # noqa: E731
    initial = [t.clone() for t in leaves(phase.params)]
    with tap.field_calls(field_kernels) as calls:
        first = opt.optimize_chunk(phase.params, phase.opt_state, frame, stream, phase.step, cfg,
                                   1, optimizer)
    grads = [m / (1.0 - optimizer.b1) for m in leaves(phase.opt_state["mu"])]
    rest = opt.optimize_chunk(phase.params, phase.opt_state, frame, stream, phase.step + 1, cfg,
                              steps - 1, optimizer)
    losses = [first["loss"].reshape(1, -1), rest["loss"].reshape(steps - 1, -1)]
    seeds = [opt.step_generator(stream, s, frame.device).initial_seed()
             for s in range(phase.step, phase.step + steps)]
    record = {
        "start": phase.step,
        "seeds": seeds,
        "losses": [list(map(float, row)) for part in losses for row in part],
        "first_grads": per_frame(grads, frames),
        "params": per_frame([t.clone() for t in leaves(phase.params)], frames),
        "initial": per_frame(initial, frames),
    }
    if phase.step >= cfg.warmup_steps:
        whole = len(calls) == 1 and {"du", "dweights"} <= set(calls[0])
        record["field"] = tap.per_frame(calls[0], frames) if whole else None
    phase.step += steps
    return record


def probe_steps(opt, phase: Phase, initial, frame, stream: int, cfg, optimizer, probes: int,
                spacing: int, frames: int) -> list:
    """First gradients of ``probes - 1`` more first steps of the phase, each
    from the initial draw and a fresh Adam state at step ``begin + k *
    spacing`` (k >= 1), through ``optimize_chunk``: independent draws of the
    same first step. Returns (step, stream seed, first gradient per frame)."""
    out = []
    for k in range(1, probes):
        step = phase.begin + k * spacing
        params = opt.tree_map(lambda t: t.clone(), initial)
        state = optimizer.init(params)
        opt.optimize_chunk(params, state, frame, stream, step, cfg, 1, optimizer)
        grads = [m / (1.0 - optimizer.b1) for _, m in opt.tree_leaves(state["mu"])]
        out.append({"start": step, "seed": opt.step_generator(stream, step, frame.device)
                    .initial_seed(), "first_grads": per_frame(grads, frames)})
    return out


def run_chunk(opt, phase: Phase, frame, stream: int, cfg, optimizer, steps: int):
    """``steps`` steps of the phase (wrapping to its start at its end);
    returns (seconds, losses)."""
    if phase.step + steps > phase.end:
        phase.step = phase.begin
    begin = time.perf_counter()
    scalars = opt.optimize_chunk(phase.params, phase.opt_state, frame, stream, phase.step, cfg,
                                 steps, optimizer)
    seconds = time.perf_counter() - begin
    phase.step += steps
    return seconds, scalars["loss"]


class Cell:
    """A cell's run after its set-up: the spec, the port's objects, each
    phase's state and the checked steps' records."""

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()


def prepare(workload: str, seed: int, device: str = "cuda", sizes: dict | None = None,
            root: Path = ROOT, profiled: bool = False) -> Cell:
    """The set-up of a run (see the module docstring). ``sizes`` overrides
    configuration keys: a rehearsal at a cut size on the CPU, where the port
    runs its kernels' plain twins. ``profiled``: the window will run under
    the profiler, so the metric steps run under it too (its start-up is
    set-up's)."""
    import numpy as np
    import torch

    c = Cell()
    c.spec = load_spec(workload, root)
    config = dict(c.spec["config"])
    if sizes:
        config = {**config, **{k: v for k, v in sizes.items() if k != "optimization"},
                  "optimization": {**config["optimization"], **sizes.get("optimization", {})}}
    c.config, c.traffic = config, c.spec["traffic"]
    c.frames = c.traffic["frames"]
    c.device, c.cuda = device, device == "cuda"
    import vsrd_tpu_torch
    if Path(vsrd_tpu_torch.__file__).resolve().parents[1] != root.resolve():
        raise RunError(f"{PACKAGE} comes from {vsrd_tpu_torch.__file__}, not from {root}")
    c.package_dir = Path(vsrd_tpu_torch.__file__).resolve().parent
    from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt
    from benchmark import params as params_mod, scenes

    made = scenes.make_scenes(seed, c.frames, config, device)
    c.stacked = scenes.stack(made)
    initial = params_mod.draw(seed, made, config["optimization"], device)
    del made
    c.opt = opt
    c.reference_start = opt.tree_map(torch.clone, initial)
    c.frame = fm.FrameData(**c.stacked)
    c.cfg = cfg = optimization_config(opt, config)
    c.optimizer = opt.Adam(cfg)
    c.stream = int(np.random.SeedSequence([seed % 2**64, 0x57EA]).generate_state(1)[0] >> 1)
    clone = lambda tree: opt.tree_map(torch.clone, tree)  # noqa: E731
    starts = c.traffic["phase_starts"]
    bounds = {"warmup": (starts["warmup"], cfg.warmup_steps),
              "residual": (starts["residual"], cfg.num_steps)}
    c.phases = {}
    for name in PHASES:
        p = clone(initial)
        c.phases[name] = Phase(name, p, c.optimizer.init(p), *bounds[name])
    c.records = {name: checked_steps(opt, c.phases[name], c.frame, c.stream, cfg, c.optimizer,
                                     c.traffic["check_steps"], c.frames) for name in PHASES}
    for name in PHASES:
        c.records[name]["probes"] = probe_steps(
            opt, c.phases[name], initial, c.frame, c.stream, cfg, c.optimizer,
            c.traffic["gradient_probes"][name], c.traffic["chunk_steps"], c.frames)
    for name in PHASES:
        # one step at a metric step, on a copy: every shape of the window has run
        phase = c.phases[name]
        s = {"mu": clone(phase.opt_state["mu"]), "nu": clone(phase.opt_state["nu"]),
             "count": phase.opt_state["count"]}
        with device_profiler(profiled and c.cuda) as prof:
            opt.optimize_chunk(clone(phase.params), s, c.frame, c.stream,
                               phase.begin + cfg.metric_interval - 1, cfg, 1, c.optimizer)
        if prof is not None:
            from benchmark import trace as tr
            tr.device_busy_s(prof)
    c.sync()
    if c.cuda:
        torch.cuda.reset_peak_memory_stats()    # the peak of what the window holds
    # set-up's objects leave the collector's view: no full collection in the
    # window walks the port's import and the checked steps' records
    gc.collect()
    gc.freeze()
    return c


def measure(c: Cell, seconds: float, profiled: bool = False) -> dict:
    """The window: chunks in the traffic's cycle until ``seconds`` have
    passed and one cycle is whole. Returns seconds per step by phase, the
    frame-steps attempted and those whose loss was not finite. With
    ``profiled`` every chunk runs under the profiler, and the device's busy
    seconds per step by phase are all of the window's chunks' busy time over
    all of their steps (the host's seconds are then the profiler's too)."""
    import numpy as np
    from benchmark import trace as tr
    chunk, cycle = c.traffic["chunk_steps"], c.traffic["cycle"]
    totals = {name: [0.0, 0] for name in PHASES}
    busy = {name: 0.0 for name in PHASES}
    chunks = {name: [] for name in PHASES}
    attempted = failed = index = 0
    start = time.perf_counter()
    while True:
        phase = c.phases[cycle[index % len(cycle)]]
        with device_profiler(profiled) as prof:
            elapsed, losses = run_chunk(c.opt, phase, c.frame, c.stream, c.cfg, c.optimizer,
                                        chunk)
        if prof is not None:
            busy[phase.name] += tr.device_busy_s(prof)
        totals[phase.name][0] += elapsed
        totals[phase.name][1] += chunk
        chunks[phase.name].append(elapsed)
        attempted += int(np.size(losses))
        failed += int(np.sum(~np.isfinite(losses)))
        index += 1
        if index >= len(cycle) and time.perf_counter() - start >= seconds:
            break
    return {"step_s": {name: totals[name][0] / totals[name][1] for name in PHASES},
            "busy_s": ({name: busy[name] / totals[name][1] for name in PHASES} if profiled
                       else None),
            "attempted": attempted, "failed": failed, "chunks": chunks}


def profile_phases(c: Cell) -> dict:
    """A chunk of each phase under ``torch.profiler``, summarized."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace as tr
    own = tr.own_kernels(c.package_dir)
    summaries = {}
    for name in PHASES:
        steps = c.traffic["profile_steps"]
        c.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            elapsed, _ = run_chunk(c.opt, c.phases[name], c.frame, c.stream, c.cfg, c.optimizer,
                                   steps)
        summaries[name] = tr.summarize(prof, steps, own, elapsed)
    return summaries


def follow_reference(c: Cell, products=None) -> dict:
    """The reference's records of each phase's checked steps (``products``:
    the control's lower precision), and its field at the points of each
    recorded field call, from the same initial draw and with the program's
    cotangents (``reference.field_at``; the boxes' alone beside it, without
    ``products``)."""
    import torch
    from benchmark import reference
    views = frames_of(c.stacked, c.frames)
    recipe = recipe_of(c.config)
    out = {}
    with reference_precision(torch):
        for name in PHASES:
            record = c.records[name]
            out[name] = reference.follow(c.reference_start, views, record["start"],
                                         record["seeds"], recipe, count=0, products=products)
            out[name]["initial"] = record["initial"]
            out[name]["probes"] = [
                {"first_grads": reference.follow(c.reference_start, views, probe["start"],
                                                 [probe["seed"]], recipe, count=0,
                                                 products=products)["first_grads"]}
                for probe in record["probes"]]
            if record.get("field"):
                out[name]["field"] = reference_field(c, record, views, recipe, products)
    return out


def reference_field(c: Cell, record: dict, views: list, recipe: dict, products) -> list:
    from benchmark import reference
    out = []
    for f, (call, view) in enumerate(zip(record["field"], views)):
        params = reference.frame_of(c.reference_start, f) if c.frames > 1 else c.reference_start
        positions = call["positions"].to(c.device)
        cotangents = {k: call[k].to(c.device) for k in ("du", "dw", "dg")}
        field = reference.field_at(params, view, record["start"], positions, recipe,
                                   cotangents, products)
        if products is None:
            field["box"] = reference.box_field_at(params, view, record["start"], positions,
                                                  recipe)
        out.append(field)
    return out


def free_program(c: Cell) -> None:
    """Drop the program's state before the reference runs."""
    del c.phases, c.frame
    if c.cuda:
        import torch
        torch.cuda.empty_cache()


def run_module(name: str, root: Path = ROOT):
    """``benchmark/runs/<name>.py`` under ``root``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"benchmark_runs_{name}",
                                                  root / "benchmark" / "runs" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: dict | None = None, root: Path = ROOT) -> dict:
    """One run of ``workload``: the result, its compared numbers last. A
    configuration that names a run module is run by it."""
    own_run = load_spec(workload, root)["config"].get("run")
    if own_run is not None:
        return run_module(own_run, root).run_cell(workload, seed, seconds, trace, device, sizes,
                                                  root)
    import torch
    from benchmark import check, trace as tr

    profiled = device == "cuda" and not trace and profiled_window(load_spec(workload, root))
    c = prepare(workload, seed, device, sizes, root, profiled)
    setup_s = time.perf_counter() - START
    window = measure(c, seconds, profiled)
    step_s = window["step_s"]
    frame_s = per_frame_s(c.cfg, step_s, c.frames)
    summaries = profile_phases(c) if trace and c.cuda else None
    memory_peak = torch.cuda.max_memory_allocated() if c.cuda else 0
    free_program(c)

    followed = follow_reference(c)
    values = check.numbers({name: check.phase_numbers(c.records[name], followed[name])
                            for name in PHASES})
    limits = c.spec["limits"]
    correct = check.judge(values, limits) and window["failed"] == 0

    if trace:
        context = {"config": c.config, "frames": c.frames, "trace": summaries,
                   "step_ms": {k: v * 1e3 for k, v in step_s.items()}, "frame_s": frame_s}
        metrics = {}
        for name, metric in c.spec["per_layer"].items():
            value = read_metric(name, context)
            if value is not None:
                metrics[name] = {"value": value, "unit": metric["unit"]}
    else:
        own_values = {"frame_s": frame_s, "setup_s": setup_s}
        if window["busy_s"]:
            own_values["busy_frame_s"] = per_frame_s(c.cfg, window["busy_s"], c.frames)
        metrics = {m["name"]: {"value": own_values[m["name"]], "unit": m["unit"]}
                   for m in c.spec["end_to_end"] if m["name"] in own_values}
    result = {
        "correct": bool(correct),
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if c.cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if c.cuda else "cpu",
            "count": c.spec["cell"]["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if summaries:
        result["device"]["busy_s"] = sum(s["busy_s"] for s in summaries.values())
        result["device"]["window_s"] = sum(s["wall_s"] for s in summaries.values())
        result["breakdown"] = tr.breakdown(summaries.values())
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in check.compared(limits)}
    return result, window["chunks"]


class reference_precision:
    """float32 products with TF32 off while the reference runs."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = False
        b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    import torch
    spec = load_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_label()}", file=sys.stderr)
    result, chunks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, seconds in chunks.items():
        print(f"{name} chunks (s): " + " ".join(f"{s:.4f}" for s in seconds), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"imported in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, item in result["checks"].items():
        print(f"check {name}: {item['value']!r} (limit {item['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
