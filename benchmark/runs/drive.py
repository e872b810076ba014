"""Run module ``drive``: one run of a cell whose configuration names
``"run": "drive"``, the port's labeling driver (``vsrd_tpu_torch.scripts.main``'s
``train``) walking its target frames on a tree written from the seed. The
worked example of the run-module contract in ``run.py``'s docstring.

Set-up (``setup_s``, from the start of the process, as ``run.py`` took it
when it runs as the harness's ``__main__``, to the driver's entry):

1. ``run.prepare`` on the cell: a scene of the cell's sizes from the seed
   (``scenes.py``), the parameters of ``params.py``, the first three steps
   of each phase through ``optimize_chunk`` at the driver's recipe, the
   first-gradient probes and a metric step of each phase, so that every
   shape the driver's steps meet has run; the program's state is then freed
   and the records are kept on the host;
2. the tree (``tree.py``): ``traffic["targets"]`` targets with their source
   frames in the KITTI-360 layout, the driver's configuration beside them;
3. the driver's own reading of that configuration (``build_config``), which
   must give the configuration's ``OptimizationConfig``, and its data path's
   native library, built on the first run in a checkout and loaded (a
   library that does not build fails the run: the data path would fall back
   to its numpy versions).

The window is the driver's ``train`` on the tree, as a labeling job runs it
(one process, ``frames_per_batch`` frames a batch, a checkpoint every
``checkpoint_interval`` steps, each frame's data read, aligned and built
before its first step). The benchmark watches it from outside: each call of
``optimize_chunk`` (a chunk ends in its copy of the scalars to the host, so
the card is done when it returns), of the dataset's ``__getitem__``, of
``align_to_target``, of ``build_frame_data`` and of the checkpoint saver,
and each record of the driver's logger. ``load_s`` is the card's wait
before each frame, summed over the window's frames and divided by their
number (a time per frame over all the window's work): from the end of the
previous frame's last chunk (for the first frame, from the driver's entry)
to the start of the frame's first chunk: the save, the read, the alignment,
the build and the driver's own work between them. The seconds a step of
each phase took in the driver's chunks are printed beside the waits, not
reported: they spread too widely from run to run for a bound. The
benchmark's own captures are spans of their own, taken out of the wait and
the wall time they fall in: ``build_frame_data``'s wrapper keeps each frame's
fields on the host for the data check, its soft masks at 0.5 one bit a
slot, and the first frame's first chunk keeps the parameters and the frame
that the driver hands it, on the host, and the loss of its first step.

``--trace 1`` runs the same window under ``torch.profiler`` (the device's
activity alone; its start-up is set-up's) and reports the per-layer metrics
(``load_work_s``, ``drive_idle_share``), the device's busy seconds over the
window and the breakdown: the device's operations, and its idle gaps by the
watched call running at each gap's middle.

After the window: the device's peak memory, then ``correct``:

* the data (``drive_reference.py``): each frame's fields against what the
  tree writer wrote;
* the optimization (``check.py``): the plain reference follows the checked
  steps of set-up, as in the frame cells;
* the driver's own first step (``drive_loss_first``): the first target's
  first step loss, as the window's chunk returned it, against the plain
  reference's first step from the parameters and the frame that the driver
  handed that chunk (the program's own start: its data stage is held by
  itself in the data check), with the step's stream seed;
* the run: every target's final checkpoint exists and holds only finite
  numbers, no frame was skipped and the driver logged no error
  (``unfinished``, ``log_errors``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import inspect
import json
import logging
import math
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from benchmark import check, drive_reference, run  # noqa: E402

RUN_NUMBERS = ("drive_loss_first", "unfinished", "log_errors")
NUMBERS = (*check.NUMBERS, *drive_reference.NUMBERS, *RUN_NUMBERS)
LOGGER = "vsrd_tpu_torch.main"
LOADED = re.compile(r"\] loaded .*: ([0-9.]+) s$")
MASK_ROWS = 1 << 20
FIELDS = ("intrinsics", "extrinsics", "gt_boxes_2d", "visible", "valid", "gt_boxes_3d")
WATCHED = {"chunk": "optimize_chunk", "read": "KITTI360Dataset.__getitem__",
           "align": "align_to_target", "build": "build_frame_data", "save": "Saver.save",
           "capture": "the benchmark's capture"}


def process_start() -> float:
    """The process's start on the host clock: ``run.py``'s ``START`` as the
    harness's ``__main__`` took it (this module's ``run`` is a second copy,
    imported later), or, in a rehearsal, the imported ``run``'s."""
    return getattr(sys.modules.get("__main__"), "START", run.START)


def named_files(spec: dict, root: Path = run.ROOT) -> list[Path]:
    """The files a run of this module reads by name, beside the cell's
    configuration, traffic and limits."""
    bench = root / "benchmark"
    return [bench / "tree.py", bench / "drive_reference.py", bench / "scenes.py",
            bench / "params.py", bench / "reference.py", bench / "check.py",
            *(bench / "metrics" / f"{name}.py" for name in spec["per_layer"])]


def merged(config: dict, sizes: dict | None) -> dict:
    """The configuration with ``sizes`` over it, dicts merged key by key (a
    rehearsal's ``sizes`` may also carry ``traffic`` keys: the number of
    targets)."""
    def merge(base, over):
        if not (isinstance(base, dict) and isinstance(over, dict)):
            return over
        return {**base, **{k: merge(base.get(k), v) for k, v in over.items()}}
    return merge(config, sizes or {})


def move(tree, device):
    """Every tensor of nested dicts and lists on ``device``."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: move(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move(v, device) for v in tree)
    return tree


def pack_masks(flat):
    """Soft masks ``[P, N]`` at 0.5 -> ``[P]`` int32 on the host, bit ``k``
    for slot ``k``, in blocks of rows (a few MB on the device at a time)."""
    import torch
    out = []
    for start in range(0, flat.shape[0], MASK_ROWS):
        block = flat[start:start + MASK_ROWS]
        word = torch.zeros(block.shape[0], dtype=torch.int32, device=block.device)
        for k in range(block.shape[1]):
            word |= (block[:, k] >= 0.5).to(torch.int32) << k
        out.append(word.cpu())
    return torch.cat(out)


def host_scene(frame) -> dict:
    """Every field of a ``FrameData`` on the host, as the reference reads a
    scene."""
    import dataclasses
    out = {}
    for field in dataclasses.fields(frame):
        value = getattr(frame, field.name)
        if value is not None:
            out[field.name] = value.detach().cpu() if hasattr(value, "detach") else value
    return out


def fields_of(frame, filename: str) -> dict:
    """What the data check reads of a built ``FrameData``, on the host."""
    fields = {k: getattr(frame, k).detach().cpu() for k in FIELDS}
    fields.update(target_index=int(frame.target_index), image_size=tuple(frame.image_size),
                  masks=pack_masks(frame.soft_masks_flat), filename=filename)
    return fields


class Watch:
    """What the benchmark sees of the driver's run: the watched calls'
    spans (host clock and wall clock in ns, which the profiler's trace
    shares), each frame's fields as built, the first frame's start as the
    driver handed it to its first chunk (``first``), and the logger's
    records."""

    def __init__(self):
        self.spans, self.built, self.records = [], [], []
        self.last_read = None
        self.first = None

    def span(self, kind, fn, info=None):
        def wrapper(*args, **kwargs):
            start, start_ns = time.perf_counter(), time.time_ns()
            out = fn(*args, **kwargs)
            item = {"kind": kind, "start": start, "end": time.perf_counter(),
                    "start_ns": start_ns, "end_ns": time.time_ns()}
            if info is not None:
                item.update(info(args, kwargs))
            self.spans.append(item)
            return out
        return wrapper

    def capture(self, fn):
        """``fn()`` as the benchmark's own capture, a span of its own."""
        return self.span("capture", fn)()

    def build(self, fn):
        built = self.span("build", fn)

        def wrapper(*args, **kwargs):
            frame = built(*args, **kwargs)
            self.built.append(self.capture(lambda: fields_of(frame, self.last_read)))
            return frame
        return wrapper

    def chunk(self, opt):
        signature = inspect.signature(opt.optimize_chunk)

        def info(args, kwargs):
            bound = signature.bind(*args, **kwargs).arguments
            return {"step": int(bound["start_step"]), "steps": int(bound["num_steps"])}

        timed = self.span("chunk", opt.optimize_chunk, info)

        def wrapper(*args, **kwargs):
            bound = signature.bind(*args, **kwargs).arguments
            first = self.first is None and int(bound["start_step"]) == 0
            if first:
                self.first = self.capture(lambda: {
                    "params": opt.tree_map(lambda t: t.detach().to("cpu", copy=True),
                                          bound["params"]),
                    "scene": host_scene(bound["frame"]), "seed": int(bound["seed"])})
            out = timed(*args, **kwargs)
            if first:
                self.first["loss"] = float(out["loss"].reshape(-1)[0])
            return out
        return wrapper

    def read(self, fn):
        def wrapper(dataset, index):
            samples = fn(dataset, index)
            self.last_read = samples[0]["filename"]
            return samples
        return self.span("read", wrapper)

    @contextlib.contextmanager
    def watching(self, driver, opt, frame_mod, kitti360, saver):
        watch = self

        class Records(logging.Handler):
            def emit(self, record):
                watch.records.append((time.perf_counter(), record.levelno, record.getMessage()))

        patches = [(opt, "optimize_chunk", self.chunk(opt)),
                   (frame_mod, "build_frame_data", self.build(frame_mod.build_frame_data)),
                   (kitti360.KITTI360Dataset, "__getitem__",
                    self.read(kitti360.KITTI360Dataset.__getitem__)),
                   (driver, "align_to_target", self.span("align", driver.align_to_target)),
                   (saver.Saver, "save", self.span("save", saver.Saver.save))]
        originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
        # the driver's logger as the driver sets it up, then read here too
        from vsrd_tpu_torch.parallel import distributed as parallel
        handler = Records()
        logger = parallel.get_logger(LOGGER, rank_zero_only=False)
        logger.addHandler(handler)
        for owner, name, wrapped in patches:
            setattr(owner, name, wrapped)
        try:
            yield self
        finally:
            for owner, name, original in originals:
                setattr(owner, name, original)
            logger.removeHandler(handler)

    def frames(self, num_steps: int) -> list[dict]:
        """Per frame, the start of its first chunk and the end of its last."""
        out = []
        for s in (s for s in self.spans if s["kind"] == "chunk"):
            if s["step"] == 0:
                out.append({"start": s["start"], "end": None})
            if out and s["step"] + s["steps"] == num_steps:
                out[-1]["end"] = s["end"]
        return [f for f in out if f["end"] is not None]


def timings(watch: Watch, entered: float, cfg) -> dict:
    """The card's waits before each frame, the frames' own seconds, the
    seconds a step of each phase took in the driver's chunks (all of them
    over all their steps), the driver's logged load seconds and the wall
    time from its entry to the end of its last frame; the benchmark's
    captures taken out of the waits and the wall time."""
    frames = watch.frames(cfg.num_steps)
    ends = [entered] + [f["end"] for f in frames[:-1]]
    logged = [float(m.group(1)) for _, _, msg in watch.records if (m := LOADED.search(msg))]

    def inside(kind, begin, end):
        return [s for s in watch.spans
                if s["kind"] == kind and begin <= s["start"] and s["end"] <= end]

    def captured(begin, end):
        return sum(s["end"] - s["start"] for s in inside("capture", begin, end))

    split = collections.Counter()
    for f, end in zip(frames, ends):
        for kind in ("read", "align", "build", "save", "capture"):
            spans = inside(kind, end, f["start"])
            split[WATCHED[kind]] += sum(s["end"] - s["start"] for s in spans)
    chunks = [s for s in watch.spans if s["kind"] == "chunk"]
    step_s = {}
    for name, phase in (("warmup", lambda s: s["step"] < cfg.warmup_steps),
                        ("residual", lambda s: s["step"] >= cfg.warmup_steps)):
        own = [s for s in chunks if phase(s)]
        steps = sum(s["steps"] for s in own)
        step_s[name] = sum(s["end"] - s["start"] for s in own) / steps if steps else math.nan
    last = frames[-1]["end"] if frames else math.nan
    return {"waits_s": [f["start"] - end - captured(end, f["start"])
                        for f, end in zip(frames, ends)],
            "wait_split_s": dict(split),
            "frames_s": [f["end"] - f["start"] for f in frames],
            "step_s": step_s,
            "logged_load_s": logged,
            "wall_s": last - entered - captured(entered, last) if frames else math.nan}


def first_loss_gap(first, opt, config: dict, device) -> float:
    """``drive_loss_first``: the relative gap of the driver's first chunk's
    first loss to the plain reference's first step from the same start."""
    import torch
    from benchmark import reference
    if first is None or "loss" not in first:
        return math.inf
    params, scene = move((first["params"], first["scene"]), device)
    seed = opt.step_generator(first["seed"], 0, device).initial_seed()
    with run.reference_precision(torch):
        followed = reference.follow(params, [scene], 0, [seed], run.recipe_of(config), count=0)
    ref = followed["losses"][0][0]
    return abs(first["loss"] - ref) / max(abs(ref), 1e-30)


def trace_summary(prof, watch: Watch, entered_ns: int, left_ns: int) -> dict:
    """The profiled window: the device's busy seconds (the union of its
    operations), its seconds by operation, and its idle gaps by the watched
    call (the latest to start) running at each gap's middle."""
    from torch.autograd import DeviceType
    from benchmark import trace as tr
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    ops = collections.Counter()
    for start, end, name in device:
        ops[tr.short_name(name)] += (end - start) / 1e9
    busy = tr.merge((s, e) for s, e, _ in device)
    edges = [entered_ns] + [x for b in busy for x in b] + [left_ns]
    spans = sorted(watch.spans, key=lambda s: s["start_ns"])
    gaps = collections.Counter()
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        middle = (start + end) / 2
        inside = [s for s in spans if s["start_ns"] <= middle <= s["end_ns"]]
        name = WATCHED[inside[-1]["kind"]] if inside else "driver, outside the watched calls"
        gaps[name] += (end - start) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9, "wall_s": (left_ns - entered_ns) / 1e9,
            "device_ops_s": dict(ops), "idle_gaps_s": dict(gaps)}


def final_checkpoints(written: dict, root: str, num_steps: int) -> list[bool]:
    """Per target, whether its final checkpoint exists and holds only finite
    numbers (the driver keeps checkpoints under the configuration's path with
    ``configs`` made ``ckpts``, one directory per image)."""
    import numpy as np
    ckpt_root = os.path.dirname(written["config"]).replace("configs", "ckpts")
    out = []
    for image in written["images"]:
        path = os.path.join(ckpt_root, os.path.splitext(os.path.relpath(image, root))[0],
                            f"step_{num_steps - 1}.npz")
        ok = os.path.exists(path)
        if ok:
            with np.load(path, allow_pickle=False) as payload:
                ok = all(np.isfinite(payload[k]).all() for k in payload.files
                         if payload[k].dtype.kind in "fc")
        out.append(ok)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: dict | None = None, root: Path = run.ROOT):
    """One run of ``workload`` (see the module docstring); returns the
    result, its compared numbers last, and the frames' waits and seconds."""
    import torch
    from benchmark import tree
    del seconds   # the window is the driver's whole run over the traffic's targets

    spec = run.load_spec(workload, root)
    config = merged(spec["config"], sizes)
    traffic = {**spec["traffic"], **config.get("traffic", {})}
    limits = spec["limits"]
    cuda = device == "cuda"
    profiled = trace and cuda
    c = run.prepare(workload, seed, device, sizes, root, profiled)
    run.free_program(c)
    c.records, c.reference_start, c.stacked = move((c.records, c.reference_start, c.stacked),
                                                   "cpu")
    workdir = tempfile.mkdtemp(prefix="vsrd-drive-")
    try:
        written = tree.write(workdir, seed, config, traffic, device)
        from vsrd_tpu_torch.data import kitti360, native
        from vsrd_tpu_torch.pipeline import frame as frame_mod
        from vsrd_tpu_torch.scripts import main as driver
        from vsrd_tpu_torch.utils import saver
        if native.load() is None:
            raise run.RunError(f"the data path's native library: {native.build_error}")
        args = argparse.Namespace(config=written["config"], train=True, launcher=None,
                                         shard=None, num_shards=None, device=device)
        cfg = driver.build_config(args)[0]
        if cfg != c.cfg:
            raise run.RunError(f"the driver reads {cfg}, the configuration states {c.cfg}")
        gc.collect()
        c.sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        watch = Watch()
        setup_s = time.perf_counter() - process_start()
        with watch.watching(driver, c.opt, frame_mod, kitti360, saver), \
                run.device_profiler(profiled) as prof:
            entered, entered_ns = time.perf_counter(), time.time_ns()
            driver.train(args)
            c.sync()
            left_ns = time.time_ns()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        times = timings(watch, entered, cfg)
        summary = trace_summary(prof, watch, entered_ns, left_ns) if prof is not None else None
        finished = final_checkpoints(written, workdir, cfg.num_steps)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    by_name = {item["filename"]: item for item in watch.built}
    built = [by_name.get(image) for image in written["images"]]
    data = drive_reference.numbers(built, written["truth"], config["filters"], device)
    del written, built, by_name
    c.records, c.reference_start, c.stacked = move((c.records, c.reference_start, c.stacked),
                                                   device)
    followed = run.follow_reference(c)
    values = check.numbers({name: check.phase_numbers(c.records[name], followed[name])
                            for name in run.PHASES})
    skipped = sum("skipping" in msg for _, level, msg in watch.records
                  if level == logging.WARNING)
    values.update(data)
    values["drive_loss_first"] = first_loss_gap(watch.first, c.opt, config, device)
    watch.first = None
    values["unfinished"] = float(finished.count(False) + skipped)
    values["log_errors"] = float(sum(level >= logging.ERROR for _, level, _ in watch.records))
    correct = check.judge(values, limits) and all(
        math.isfinite(values[k]) and values[k] <= limits[k]
        for k in (*drive_reference.NUMBERS, *RUN_NUMBERS))
    print(f"drive: {len(times['waits_s'])} frames; wait (s) "
          + " ".join(f"{s:.4f}" for s in times["waits_s"]) + "; logged load (s) "
          + " ".join(f"{s:.3f}" for s in times["logged_load_s"])
          + "; seconds a step " + json.dumps(times["step_s"])
          + "; the waits' watched calls (s) " + json.dumps(times["wait_split_s"]),
          file=sys.stderr)

    if trace:
        context = {"config": config, "trace": summary, "drive": times}
        metrics = {}
        for name, metric in spec["per_layer"].items():
            value = run.read_metric(name, context)
            if value is not None:
                metrics[name] = {"value": value, "unit": metric["unit"]}
    else:
        own = {"setup_s": setup_s}
        if times["waits_s"]:
            own["load_s"] = sum(times["waits_s"]) / len(times["waits_s"])
        metrics = {m["name"]: {"value": own[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in own}
    result = {
        "correct": bool(correct),
        "attempted": len(finished),
        "failed": finished.count(False),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": spec["cell"]["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["wall_s"]
        from benchmark import trace as tr
        result["breakdown"] = tr.breakdown([summary])
    compared = [*check.compared(limits), *drive_reference.NUMBERS, *RUN_NUMBERS]
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in compared}
    json.dumps(result)
    return result, {"wait": times["waits_s"], "frame": times["frames_s"]}


def data_readings(args) -> None:
    """The data check's readings (``--numbers data``): for each seed the
    tree, then each target's frame through the driver's own data calls (its
    dataset, ``align_to_target`` and ``build_frame_data``, as its loop calls
    them, without the optimization), and the data numbers of the sound
    frames (``sound``) and of the control (``control``: the reference's K
    and rectified extrinsics in bfloat16, ``drive_reference.camera_control``)."""
    from benchmark import tree
    from vsrd_tpu_torch.pipeline import frame as frame_mod
    from vsrd_tpu_torch.scripts import main as driver
    spec = run.load_spec(args.workload)
    config, filters = spec["config"], spec["config"]["filters"]
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="vsrd-drive-")
        try:
            written = tree.write(workdir, seed, config, spec["traffic"], args.device)
            dataset = driver.make_dataset(driver.build_config(argparse.Namespace(
                config=written["config"]))[1])
            built = []
            for index in range(len(dataset)):
                samples = dataset[index]
                kwargs = driver.align_to_target(samples, max_instances=driver.round_up_instances(
                    len(samples[0]["instance_ids"])))
                frame = frame_mod.build_frame_data(None, **kwargs, device=args.device)
                built.append(fields_of(frame, samples[0]["filename"]))
                del frame
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        sound = drive_reference.numbers(built, written["truth"], filters, args.device)
        control = {"data_camera": drive_reference.camera_control(written["truth"], filters)}
        print(json.dumps({"workload": args.workload, "seed": seed, "sound": sound,
                          "control": control}), flush=True)


def loss_readings(args) -> None:
    """``drive_loss_first``'s readings (``--numbers loss``): for each seed a
    run of the cell over its first target alone, sound, and on the fault
    seeds with half of each step's rays (``control.half_batch``) planted in
    the program (an unchanged state leaves a first loss as it is)."""
    from benchmark import control
    from vsrd_tpu_torch.pipeline import optimize as opt
    one = {"traffic": {"targets": 1}}
    for seed in args.seeds:
        runs = {"sound": contextlib.nullcontext()}
        if seed in args.fault_seeds:
            runs["half_batch"] = control.half_batch(opt)
        line = {"workload": args.workload, "seed": seed}
        for name, planted in runs.items():
            with planted:
                result, _ = run_cell(args.workload, seed, 0.0, False, args.device, one)
            line[name] = result["checks"]["drive_loss_first"]["value"]
        print(json.dumps(line), flush=True)


def readings(argv=None) -> None:
    """Readings for this cell's limits, one JSON line a seed::

        python3 benchmark/runs/drive.py --numbers data --seeds 11 12 13
        python3 benchmark/runs/drive.py --numbers loss --seeds 11 12 13 --fault-seeds 11
    """
    parser = argparse.ArgumentParser(description=readings.__doc__.splitlines()[0])
    parser.add_argument("--workload", default="b16-drive")
    parser.add_argument("--numbers", choices=("data", "loss"), default="data")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    (data_readings if args.numbers == "data" else loss_readings)(args)


if __name__ == "__main__":
    readings()
