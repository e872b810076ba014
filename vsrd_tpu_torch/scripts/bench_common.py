"""What the port's measuring entry points and ``chip_smoke.py`` share:
the bench scenes, the field kernels' random inputs, the card's label, the
device check and the timers.

The measuring scripts (``steptime``, ``kernelbench``, ``roofline``,
``photobench``, ``profile``) are counterparts of the JAX package's
top-level ``scripts/``. Run them as modules::

    python -m vsrd_tpu_torch.scripts.steptime [--frames 8]

(run by path, ``profile.py`` would shadow the standard library's
``profile`` module). Each takes ``--device`` (default ``cuda``); without a
card it fails unless ``--device cpu`` asks for a rehearsal on the plain
twins, whose times are the CPU's and never a device metric. On the card
each one builds the kernels before anything is timed and prints every
time beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..pipeline import frame as fm, optimize as opt, sharded
from ..rendering import field_kernels

# The integer seeds that the JAX package's synthetic_frame draws from
# jax.random.PRNGKey(i) (jax.random.randint(key, (), 0, 2**31 - 1)), for
# i = 0..7: with them the port's scripts optimize the JAX scripts' scenes.
SCENE_SEEDS = (31327077, 1733648124, 2128942160, 111646283, 591994711, 359975681,
               828436750, 752193312)
# the JAX scripts' image size (their synthetic frames are 376x1408)
IMAGE_SIZE = (376, 1408)
# the seed of the parameters' draw (tools/torch_port/quality.py's) and of
# the per-step random stream (the JAX scripts' PRNGKey(1) and PRNGKey(2))
INIT_SEED = 1
STEP_SEED = 2
CPU_LABEL = "cpu (no device metric)"
# the order in which the JAX scripts draw the field's inputs from
# np.random.default_rng(0): scripts/kernelbench.py and scripts/roofline.py
KERNELBENCH_DRAWS = ("pos", "loc", "half", "weights")
ROOFLINE_DRAWS = ("weights", "loc", "half", "pos")
TEMPERATURE = 0.5
EVENT_REPEATS = 20


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def prepare_device(device: str) -> str:
    """Check that ``device`` can run, build the kernels on a card (so that
    no nvcc run falls inside a time), and return the label printed beside
    every number: the card's name and power limit, or ``CPU_LABEL``."""
    if device == "cpu":
        return CPU_LABEL
    if device != "cuda":
        raise SystemExit(f"--device is cuda or cpu, not {device!r}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: these scripts measure a card "
                         "(--device cpu runs a rehearsal on the plain twins)")
    field_kernels.build_library()
    return card_name_and_power()


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def synthetic_frames(seeds, device: str, **kwargs) -> list:
    """``synthetic_frame(seed, device=device, **kwargs)`` for each of
    ``seeds``, at full width unless ``kwargs`` say otherwise (17 views at
    376x1408, 8 instances), built on host threads: the frame build is
    numpy, which releases the interpreter lock in its array work."""
    kwargs = dict(dict(num_views=17, image_size=IMAGE_SIZE, num_instances=8,
                       max_instances=8), **kwargs)
    workers = max(1, min(len(seeds), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda s: fm.synthetic_frame(s, device=device, **kwargs), seeds))


def bench_frames(count: int, views: int = 17, size=IMAGE_SIZE, instances: int = 8,
                 layout: str = "compact", with_images: bool = False,
                 device: str = "cuda") -> list:
    """The JAX scripts' scenes ``synthetic_frame(PRNGKey(i))`` for i <
    ``count``, with ``instances`` instances (all of them valid)."""
    if not 1 <= count <= len(SCENE_SEEDS):
        raise ValueError(f"1 to {len(SCENE_SEEDS)} bench frames, not {count}")
    return synthetic_frames(SCENE_SEEDS[:count], device, num_views=views,
                            image_size=tuple(size), num_instances=instances,
                            max_instances=instances, layout=layout, with_images=with_images)


def script_inputs(points: int, instances: int, rdf: bool, device: str,
                  draws=KERNELBENCH_DRAWS) -> dict:
    """The JAX kernel scripts' inputs of the field, drawn from
    ``np.random.default_rng(0)`` in the order ``draws``: positions
    N(0, 20^2), locations N(0, 10^2), half sizes U(0.5, 2) and flat field
    weights ``[N, 1617]`` N(0, 0.3^2) (``None`` unless ``rdf``); identity
    rotations, every instance valid, temperature 0.5."""
    n = instances
    rng = np.random.default_rng(0)
    draw = {
        "pos": lambda: rng.normal(size=(points, 3)).astype(np.float32) * 20,
        "loc": lambda: rng.normal(size=(n, 3)).astype(np.float32) * 10,
        "half": lambda: rng.uniform(0.5, 2.0, size=(n, 3)).astype(np.float32),
        "weights": lambda: rng.normal(size=(n, field_kernels.NUM_WEIGHTS)).astype(
            np.float32) * 0.3,
    }
    x = {name: torch.as_tensor(draw[name](), device=device) for name in draws}
    return dict(x, rot=torch.eye(3, device=device).expand(n, 3, 3),
                valid=torch.ones(n, device=device), weights=x["weights"] if rdf else None,
                tau=torch.tensor(TEMPERATURE, device=device))


def bench_state(frames: list, cfg: opt.OptimizationConfig, device: str):
    """``(frame, params, optimizer, opt_state)`` for one frame, or for
    ``len(frames) > 1`` the frames stacked with ``init_params_batched``;
    the parameters drawn from ``INIT_SEED``, as ``optimize_frame`` and
    ``optimize_frames_batched`` draw them."""
    if len(frames) == 1:
        frame = frames[0]
        generator = torch.Generator().manual_seed(INIT_SEED)
        params = opt.tree_map(lambda t: t.to(device),
                              opt.init_params(generator, frame.max_instances, cfg))
    else:
        frame = sharded.stack_frames(frames)
        params = opt.init_params_batched(INIT_SEED, len(frames), frame.max_instances, cfg,
                                         device)
    optimizer = opt.Adam(cfg)
    return frame, params, optimizer, optimizer.init(params)


def _copy(tree):
    return opt.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def run_chunk(params, opt_state, frame, cfg: opt.OptimizationConfig, start: int,
              steps: int, optimizer: opt.Adam, seed: int = STEP_SEED):
    """``optimize_chunk`` of ``steps`` steps from step ``start`` on copies
    of ``params`` and ``opt_state`` (the JAX chunk is a pure function of
    them, so every run starts from the same state), ending in a
    synchronize. Returns its ms/step on the host clock and its scalars."""
    p, s = _copy(params), _copy(opt_state)
    device = frame.device.type
    sync(device)
    begin = time.perf_counter()
    scalars = opt.optimize_chunk(p, s, frame, seed, start, cfg, steps, optimizer)
    sync(device)
    return (time.perf_counter() - begin) * 1e3 / steps, scalars


def time_chunk(params, opt_state, frame, cfg: opt.OptimizationConfig, start: int,
               steps: int, optimizer: opt.Adam, repeats: int = 3,
               seed: int = STEP_SEED) -> dict:
    """ms/step of ``run_chunk``: one untimed chunk, then ``repeats`` timed
    ones. Returns their median, min and max and every sample, with the
    last chunk's scalars."""
    _, scalars = run_chunk(params, opt_state, frame, cfg, start, steps, optimizer, seed)
    samples = []
    for _ in range(repeats):
        ms, scalars = run_chunk(params, opt_state, frame, cfg, start, steps, optimizer, seed)
        samples.append(ms)
    return {"median": statistics.median(samples), "min": min(samples), "max": max(samples),
            "samples": samples, "scalars": scalars}


def field_inputs(num_points: int, num_instances: int = 8, num_valid: int = 6, seed: int = 0,
                 device: str = "cuda"):
    """Field inputs shaped like the main path's: points along rays from a
    camera at the origin over 0-100 m, boxes 5-40 m ahead (the first
    ``num_valid`` valid), field weights from a random hypernetwork-sized
    layer, and cotangents ``du``, ``dw``, ``dg`` for the backward."""
    rng = np.random.default_rng(seed)
    n = num_instances
    dirs = rng.normal(size=(num_points, 3)) * [0.3, 0.1, 1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = dirs * rng.uniform(0.0, 100.0, size=(num_points, 1))
    loc = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.3, 0.8, n), rng.uniform(5, 40, n)], -1)
    yaw = rng.uniform(-0.4, 0.4, n)
    rot = np.stack([
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]] for a in yaw
    ])
    half = rng.uniform([0.75, 0.75, 1.5], [1.0, 1.0, 2.5], size=(n, 3))
    valid = (np.arange(n) < num_valid).astype(np.float32)
    weights = rng.normal(size=(n, field_kernels.NUM_WEIGHTS)) * 0.3
    cot = dict(
        du=rng.normal(size=num_points), dw=rng.normal(size=(num_points, n)),
        dg=rng.normal(size=(num_points, 3)),
    )
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return dict(
        pos=t(pos), dirs=t(dirs), loc=t(loc), rot=t(rot), half=t(half), valid=t(valid),
        weights=t(weights), tau=torch.tensor(0.5, device=device),
        **{k: t(v) for k, v in cot.items()},
    )


def event_ms(fn, repeats: int = EVENT_REPEATS) -> float:
    """Mean ms per call of ``fn`` on CUDA events over ``repeats``
    back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def write_json(path: str | None, report: dict) -> None:
    """Write ``report`` to ``path`` when one was given (``--out``); the
    scripts write no file of their own."""
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
