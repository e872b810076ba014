"""The converged-parity noise floor on the PyTorch port: the JAX package's
noise-floor trials, run by the port on the same scenes, inits and ray
schedules, and held against the JAX package's stored runs and the
original PyTorch VSRD's.

BASELINE.md's contract, "3D box IoU within 1e-2 of the PyTorch
reference", is judged at the noise floor (``tools/parity/noise_floor.py``):
1500 Adam steps on a non-convex landscape move the converged IoU from
trial to trial, so a scene holds when the gap between two sides' mean
IoU over the same trials is at most the other side's own spread (max -
min over the trials), or 1e-2 if that is larger. The trials:

* scenes 0 and 7, ``synthetic_frame(SCENE_SEEDS[s])`` with 6 views at
  96x128 and 3 instances (the JAX tool's ``PRNGKey(s)`` scenes);
* trial t starts from the JAX package's ``init_params(PRNGKey(1 + t))``,
  read from ``nf_inputs.npz`` (``tests/make_torch_nf_inputs.py`` draws it
  with JAX; a test keeps it equal to what JAX draws), and renders the rays
  of ``ray_schedule(seed=1234 + 1000 t)``, numpy, as the JAX tool draws
  them;
* 1500 steps (500 box-only warmup), 512 rays, 24+24 samples,
  ``deterministic=True``, Adam from zero moments.

``--precision highest`` is the JAX tool's strict config (its ``_ours``
runs, trials 0-4); ``--precision default`` its ``--production`` config
(``_ours_prod``, trials 0-3): bf16 products and the coarse pass through
K3 with the residual field (``kernel_box_coarse=False``). One frame at a
time runs K1-K3; ``--batched`` stacks every trial of every scene into one
frame batch (per-frame inits, ``ray_indices [F, 512]``) through K4a-c. The
batched loss is the sum of the frames' losses, so each frame's gradient is
its single-frame gradient (no scaling by F); Adam is per element.

Runs go to ``nf_runs/s{s}_t{t}_port[_prod][_batched].json`` in the JAX
tool's schema (``boxes``, ``matched_gt_iou``, ``mean_gt_iou``,
``elapsed_s``, ``recipe``) plus the card's name and power limit, the
precision, the frames of the run (``elapsed_s`` is the whole run's) and
each field kernel's launches; a trial with a run file is skipped (delete
the file to run it again). ``--summarize`` folds them against the
stored ``tools/parity/nf_runs`` (the JAX package's ``_ours[_prod]`` and
the reference's ``_torch``) into ``NOISE_FLOOR_port[_prod].json``::

    python3 tools/torch_port/noise_floor.py [--precision default|highest] [--batched]
    python3 tools/torch_port/noise_floor.py --summarize [--precision highest]
    python3 tools/torch_port/noise_floor.py --device cpu --steps 6 --warmup 2 --rays 32 \\
        --samples 4 --trials 1 --runs-dir /tmp/nf_rehearsal     # rehearsal on the CPU

It runs on the card unless ``--device cpu`` asks for the plain twins.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import scipy.optimize  # noqa: E402
import torch  # noqa: E402

from vsrd_tpu_torch.models import box_parameters  # noqa: E402
from vsrd_tpu_torch.ops import geometry, iou3d  # noqa: E402
from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt, sharded  # noqa: E402
from vsrd_tpu_torch.rendering import field_kernels as fk  # noqa: E402
from vsrd_tpu_torch.scripts.bench_common import (  # noqa: E402
    CPU_LABEL, SCENE_SEEDS, card_name_and_power)
from vsrd_tpu_torch.utils import convert, saver  # noqa: E402

RUNS_DIR = os.path.join(_HERE, "nf_runs")
PARITY_RUNS_DIR = os.path.join(_ROOT, "tools", "parity", "nf_runs")
INPUTS = os.path.join(_HERE, "nf_inputs.npz")
SCENES = (0, 7)
PRECISIONS = ("default", "highest")
# the stored trials of each precision: the JAX runs _ours (0-4), _ours_prod (0-3)
TRIALS = {"highest": 5, "default": 4}
# the JAX run files' tag of each precision
JAX_TAG = {"highest": "", "default": "_prod"}
# the rule's floor under a side's own spread
MIN_BAR = 1e-2
LAUNCHERS = {"K1/K4a": fk.field_forward, "K2/K4c": fk.field_backward,
             "K3/K4b": fk.field_dir_forward}


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The JAX tool's defaults: its trials' recipe."""

    steps: int = 1500
    warmup: int = 500
    rays: int = 512
    samples: int = 24
    views: int = 6
    instances: int = 3
    height: int = 96
    width: int = 128

    def record(self) -> dict:
        """The JAX run files' ``recipe`` entry."""
        return {k: getattr(self, k) for k in
                ("steps", "warmup", "rays", "samples", "views", "instances")}


def make_config(recipe: Recipe, precision: str) -> opt.OptimizationConfig:
    """The JAX tool's config at ``precision``: strict ("highest") or its
    ``--production`` config ("default", the coarse pass with the residual
    field, as its ``pallas_box_coarse=False``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, not {precision!r}")
    return opt.OptimizationConfig(
        num_steps=recipe.steps, warmup_steps=recipe.warmup, num_rays=recipe.rays,
        num_samples=recipe.samples, deterministic=True, metric_interval=recipe.steps,
        checkpoint_interval=recipe.steps, kernel_matmul_precision=precision,
        **({"kernel_box_coarse": False} if precision == "default" else {}))


def build_scene(scene: int, recipe: Recipe, device) -> fm.FrameData:
    """The JAX tool's scene ``scene`` (``run_parity.build_scene``)."""
    return fm.synthetic_frame(SCENE_SEEDS[scene], num_views=recipe.views,
                              image_size=(recipe.height, recipe.width),
                              num_instances=recipe.instances, max_instances=recipe.instances,
                              device=device)


def soft_masks(frame: fm.FrameData) -> np.ndarray:
    """The frame's stored soft masks, bf16-rounded, as ``[V, H, W, N]`` f32."""
    h, w = frame.image_size
    masks = frame.soft_masks_flat.float().cpu().numpy()
    return masks.reshape(frame.num_views, h, w, frame.max_instances)


def ray_schedule(masks: np.ndarray, num_steps: int, num_rays: int, seed: int = 1234):
    """``run_parity.ray_schedule`` line for line: per step, ``num_rays``
    flat (view, y, x) indices drawn without replacement by Gumbel top-k
    over the max-over-instances soft mask ``masks [V, H, W, N]``."""
    weights = masks.max(-1).reshape(-1)  # [V*H*W]
    logw = np.where(weights > 0, np.log(np.maximum(weights, 1e-30)), -np.inf)
    rng = np.random.default_rng(seed)
    schedule = np.empty((num_steps, num_rays), np.int32)
    for s in range(num_steps):
        g = rng.gumbel(size=logw.shape).astype(np.float64)
        keys = logw + g
        cand = np.argpartition(-keys, num_rays - 1)[:num_rays]
        schedule[s] = cand[np.argsort(-keys[cand], kind="stable")]
    return schedule


def schedule_seed(trial: int) -> int:
    return 1234 + 1000 * trial


def load_inits(path: str = INPUTS) -> list:
    """The JAX package's ``init_params(PRNGKey(1 + t), 3, cfg)`` for each
    stored trial t, as numpy trees."""
    return saver.load_checkpoint(path)


def trial_inputs(scene: int, trial: int, recipe: Recipe, device, inits: list | None = None):
    """``(frame, schedule [steps, rays] int32, init params)`` of one trial,
    the same on both sides."""
    frame = build_scene(scene, recipe, device)
    schedule = ray_schedule(soft_masks(frame), recipe.steps, recipe.rays,
                            seed=schedule_seed(trial))
    inits = load_inits() if inits is None else inits
    if recipe.instances != inits[trial]["boxes"]["locations"].shape[0]:
        raise ValueError(f"the stored inits have {inits[trial]['boxes']['locations'].shape[0]} "
                         f"instances, the recipe {recipe.instances}")
    return frame, schedule, convert.params_from_jax(inits[trial], device=device)


def run_port(frames: list, inits: list, schedules: list, cfg: opt.OptimizationConfig):
    """``train_step`` for ``cfg.num_steps`` steps with each step's rays from
    the schedules, Adam from zero moments; one frame alone, or F > 1
    stacked (``sharded.stack_frames``, params stacked per frame,
    ``ray_indices [F, R]``). Returns the decoded boxes ``[F, N, 8, 3]`` and
    the last step's scalars ``{name: [F]}``, as numpy."""
    batched = len(frames) > 1
    frame = sharded.stack_frames(frames) if batched else frames[0]
    params = opt.tree_stack(inits) if batched else inits[0]
    params = opt.tree_map(lambda t: t.detach().clone().to(frame.device), params)
    rays = torch.as_tensor(np.stack(schedules, axis=1), device=frame.device)   # [S, F, R]
    if not batched:
        rays = rays[:, 0]
    optimizer = opt.Adam(cfg)
    state = optimizer.init(params)
    for step in range(cfg.num_steps):
        scalars = opt.train_step(params, state, frame, step, cfg, optimizer,
                                 ray_indices=rays[step])
    boxes = box_parameters.decode_boxes(params["boxes"])["boxes_3d"]
    boxes = boxes.detach().cpu().numpy().reshape(len(frames), -1, 8, 3)
    scalars = {k: np.atleast_1d(v.cpu().numpy()) for k, v in scalars.items()}
    return boxes, scalars


def iou_3d_pairs(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Per-instance 3D IoU of two ``[N, 8, 3]`` camera-space box sets,
    rotated to z up as in the KITTI-360 evaluation (``run_parity``'s)."""
    rot = geometry.rotation_matrix_x(-np.pi / 2.0).numpy()
    a = torch.as_tensor(np.asarray(boxes_a, np.float32) @ rot.T)
    b = torch.as_tensor(np.asarray(boxes_b, np.float32) @ rot.T)
    return iou3d.box_3d_iou(a, b)[0].numpy().astype(np.float64)


def matched_iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray):
    """Hungarian-matched per-instance 3D IoU of two box sets and the match
    (``run_parity.matched_iou_3d``): the instances' labels are a gauge
    freedom, so each side's boxes are matched before they are compared."""
    n = boxes_a.shape[0]
    cost = np.zeros((n, n))
    for j in range(n):
        cost[:, j] = -iou_3d_pairs(boxes_a, np.broadcast_to(boxes_b[j], boxes_a.shape))
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    return -cost[rows, cols], cols


def verdict(port: list, other: list) -> dict:
    """The stored rule: |mean(port) - mean(other)| <= max(spread(other),
    1e-2), spread = max - min over the trials."""
    port, other = np.asarray(port, np.float64), np.asarray(other, np.float64)
    gap = float(abs(port.mean() - other.mean()))
    bar = float(max(other.max() - other.min(), MIN_BAR))
    return {"gap": gap, "bar": bar, "holds": gap <= bar}


def run_name(scene: int, trial: int, precision: str, batched: bool) -> str:
    return f"s{scene}_t{trial}_port{JAX_TAG[precision]}{'_batched' if batched else ''}.json"


def jax_run_path(scene: int, trial: int, side: str, precision: str,
                 parity_dir: str = PARITY_RUNS_DIR) -> str:
    """A stored run of the JAX package (``side="ours"``) or of the
    reference (``"torch"``, whose strict runs serve both precisions)."""
    tag = JAX_TAG[precision] if side == "ours" else ""
    return os.path.join(parity_dir, f"s{scene}_t{trial}_{side}{tag}.json")


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def stored_runs(scene: int, trial: int, precision: str,
                parity_dir: str = PARITY_RUNS_DIR) -> dict:
    """The stored JAX (``"jax"``) and reference (``"torch"``) runs of one trial."""
    return {"jax": read_json(jax_run_path(scene, trial, "ours", precision, parity_dir)),
            "torch": read_json(jax_run_path(scene, trial, "torch", precision, parity_dir))}


def gt_iou(boxes, frame: fm.FrameData) -> np.ndarray:
    """The Hungarian-matched per-instance IoU of ``boxes`` against the
    frame's GT boxes."""
    gt = frame.gt_boxes_3d[:len(boxes)].cpu().numpy()
    return matched_iou_3d(np.asarray(boxes), gt)[0]


def cross_iou(boxes, run: dict) -> float:
    """The mean matched IoU of ``boxes`` against a stored run's boxes."""
    return float(matched_iou_3d(np.asarray(boxes), np.asarray(run["boxes"]))[0].mean())


def run_payload(boxes, frame: fm.FrameData, recipe: Recipe, elapsed: float, card: str,
                precision: str, frames: int, launches: dict) -> dict:
    gt = gt_iou(boxes, frame)
    return {
        "boxes": np.asarray(boxes).tolist(),
        "matched_gt_iou": gt.tolist(),
        "mean_gt_iou": float(gt.mean()),
        "elapsed_s": elapsed,
        "recipe": recipe.record(),
        "card": card,
        "precision": precision,
        "frames_in_run": frames,
        "launches": launches,
    }


def launch_counts() -> dict:
    return {name: {"launches": f.launches, "batched": f.batched_launches,
                   "rdf": f.rdf_launches, "bf16": f.bf16_launches}
            for name, f in LAUNCHERS.items()}


def run_trials(trials: list, recipe: Recipe, precision: str, batched: bool, device: str,
               card: str, runs_dir: str = RUNS_DIR) -> list:
    """Run ``trials`` (``(scene, trial)`` pairs) that have no run file yet,
    one at a time or all in one batch, and write each one's run file;
    returns the payloads."""
    todo = [(s, t) for s, t in trials
            if not os.path.exists(os.path.join(runs_dir, run_name(s, t, precision, batched)))]
    for s, t in sorted(set(trials) - set(todo)):
        print(f"skip existing {run_name(s, t, precision, batched)}", flush=True)
    if not todo:
        return []
    cfg = make_config(recipe, precision)
    inits = load_inits()
    inputs = [trial_inputs(s, t, recipe, device, inits) for s, t in todo]
    groups = [list(range(len(todo)))] if batched else [[i] for i in range(len(todo))]
    os.makedirs(runs_dir, exist_ok=True)
    payloads = []
    for group in groups:
        fk.reset_launch_counts()
        if device == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        boxes, _ = run_port([inputs[i][0] for i in group], [inputs[i][2] for i in group],
                            [inputs[i][1] for i in group], cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        for k, i in enumerate(group):
            s, t = todo[i]
            payload = run_payload(boxes[k], inputs[i][0], recipe, elapsed, card, precision,
                                  len(group), launches)
            with open(os.path.join(runs_dir, run_name(s, t, precision, batched)), "w") as fh:
                json.dump(payload, fh)
            payloads.append(payload)
            print(f"port s{s} t{t} {precision}{' batched' if batched else ''}: mean_gt_iou="
                  f"{payload['mean_gt_iou']:.4f} ({elapsed:.1f} s for {len(group)} frame(s) "
                  f"on {card})", flush=True)
        print(f"launches: {json.dumps(launches)}", flush=True)
    return payloads


def summarize_scene(scene: int, precision: str, batched: bool, runs_dir: str,
                    parity_dir: str) -> dict:
    """One scene of one mode: the port's runs against the stored JAX and
    reference runs of the same trials."""
    rows = {"port": [], "jax": [], "torch": [], "cross_jax": [], "cross_torch": [],
            "elapsed_s": [], "trials": [], "cards": set()}
    for trial in range(TRIALS[precision]):
        path = os.path.join(runs_dir, run_name(scene, trial, precision, batched))
        if not os.path.exists(path):
            continue
        port = read_json(path)
        stored = stored_runs(scene, trial, precision, parity_dir)
        if port["recipe"] != stored["jax"]["recipe"]:
            raise ValueError(f"{path}: recipe {port['recipe']} is not the stored "
                             f"runs' {stored['jax']['recipe']}")
        rows["trials"].append(trial)
        rows["port"].append(port["mean_gt_iou"])
        for side, run in stored.items():
            rows[side].append(run["mean_gt_iou"])
            rows[f"cross_{side}"].append(cross_iou(port["boxes"], run))
        rows["elapsed_s"].append(port["elapsed_s"])
        rows["cards"].add(port.get("card", CPU_LABEL))
    if len(rows["trials"]) < TRIALS[precision]:
        return {"incomplete": rows["trials"]}
    entry = {"trials": rows["trials"], "cards": sorted(rows["cards"])}
    for side in ("port", "jax", "torch"):
        values = np.asarray(rows[side])
        entry[f"{side}_mean_gt_iou_per_trial"] = values.tolist()
        entry[f"{side}_mean"] = float(values.mean())
        entry[f"{side}_self_spread"] = float(values.max() - values.min())
        entry[f"{side}_self_std"] = float(values.std())
    for side in ("jax", "torch"):
        rule = verdict(rows["port"], rows[side])
        entry[f"gap_to_{side}"] = rule["gap"]
        entry[f"bar_{side}"] = rule["bar"]
        entry[f"holds_against_{side}"] = rule["holds"]
        entry[f"cross_iou_{side}_same_trial"] = rows[f"cross_{side}"]
    entry["elapsed_s"] = rows["elapsed_s"]
    return entry


def summarize(precision: str, runs_dir: str = RUNS_DIR, parity_dir: str = PARITY_RUNS_DIR,
              out_dir: str = _HERE) -> dict:
    """Fold the port's runs of ``precision`` (single-frame and batched)
    into ``NOISE_FLOOR_port[_prod].json`` in ``out_dir``."""
    report = {
        "precision": precision,
        "recipe": Recipe().record(),
        "rule": "holds iff |mean(port) - mean(other)| <= max(max - min of other, 1e-2) "
                "over the same trials (tools/parity/noise_floor.py)",
        "jax_runs": f"s{{s}}_t{{t}}_ours{JAX_TAG[precision]}.json",
        "torch_runs": "s{s}_t{t}_torch.json",
        "modes": {},
    }
    for batched in (False, True):
        report["modes"]["batched" if batched else "single"] = {
            str(scene): summarize_scene(scene, precision, batched, runs_dir, parity_dir)
            for scene in SCENES}
    out = os.path.join(out_dir, f"NOISE_FLOOR_port{JAX_TAG[precision]}.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--summarize", action="store_true")
    parser.add_argument("--precision", choices=PRECISIONS, default="default")
    parser.add_argument("--batched", action="store_true",
                        help="every trial of every scene as one frame batch (K4a-c)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--trials", type=int, default=None,
                        help="trials 0..T-1 (default: the stored trials of the precision)")
    defaults = Recipe()
    for field in ("steps", "warmup", "rays", "samples"):
        parser.add_argument(f"--{field}", type=int, default=getattr(defaults, field))
    parser.add_argument("--runs-dir", default=RUNS_DIR)
    args = parser.parse_args(argv)

    if args.summarize:
        return summarize(args.precision, runs_dir=args.runs_dir)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (use --device cpu for a rehearsal)")
        fk.build_library()
        card = card_name_and_power()
    else:
        card = CPU_LABEL
    print(card, flush=True)
    recipe = Recipe(steps=args.steps, warmup=args.warmup, rays=args.rays, samples=args.samples)
    trials = [(s, t) for s in SCENES
              for t in range(TRIALS[args.precision] if args.trials is None else args.trials)]
    return run_trials(trials, recipe, args.precision, args.batched, args.device, card,
                      runs_dir=args.runs_dir)


if __name__ == "__main__":
    main()
