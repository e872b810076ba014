"""The port's auto-labeling driver.

Counterpart of ``scripts/main.py``: the same CLI, configs and checkpoint
files. Per target frame, the Adam optimization of 3D boxes and residual
distance fields against multi-view silhouettes (``pipeline.optimize``), in
checkpoint-sized chunks. Frames are sharded round-robin across processes
(no gradient crosses them); each process pads its frames to an instance
bucket, co-optimizes ``frames_per_batch`` frames of one bucket on its card,
writes a ``.npz`` checkpoint every ``ckpt_intervals`` steps with the Adam
state beside the parameters, skips frames whose final checkpoint exists,
and resumes a preempted frame from its latest checkpoint. The checkpoints
load in the JAX package's ``load_checkpoint`` (and so in
``tools/kitti_360/make_predictions.py``), and a JAX checkpoint resumes here.

Usage:
    python -m vsrd_tpu_torch.scripts.main --config configs/kitti_360/vsrd/<drive>/config.json --train
    torchrun --nproc-per-node 4 -m vsrd_tpu_torch.scripts.main --config ... --train --launcher torchrun

``--device cpu`` runs on the CPU through the kernels' plain twins (at small
sizes). Scalars go to tensorboardX when it is installed, and at checkpoints
that fall on ``image_intervals`` the diagnostic image panels
(``visualization/panels.py``) too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
import zipfile

import numpy as np
import torch

from ..configuration.configurator import Configurator
from ..configuration.registry import instantiate
from ..data.kitti360 import KITTI360Dataset, align_to_target
from ..parallel import distributed as parallel
from ..pipeline import frame as frame_mod
from ..pipeline import optimize as opt
from ..pipeline import sharded
from ..utils import convert
from ..utils.meters import ProgressMeter, StopWatch
from ..utils.saver import Saver, has_final_checkpoint
from ..visualization import panels

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None

# the JAX package's kernel knobs: their port's names, or None where the
# port has no such knob (the XLA field path and the TPU tile sizes)
KERNEL_KNOBS = {
    "pallas_matmul_precision": "kernel_matmul_precision",
    "pallas_dir_coarse": "kernel_dir_coarse",
    "pallas_box_coarse": "kernel_box_coarse",
    "pallas_group_skip": "kernel_group_skip",
    "pallas_rev_grad": None,
    "pallas_tile": None,
    "pallas_bwd_tile": None,
    "pallas_box_tile": None,
    "use_pallas": None,
    "field_dtype": None,
    "remat_fields": None,
}


def round_up_instances(n, buckets=(8, 16, 24, 32)):
    """Pad instance counts to a few buckets, as the JAX driver does, so a
    run meets a few shapes; beyond the last bucket, the next multiple of 8
    (the kernels take up to 64 instances)."""
    for bucket in buckets:
        if n <= bucket:
            return bucket
    return -(-n // 8) * 8


def build_config(args, logger=None):
    """The config file (merged down its directory tree) and the port's
    ``OptimizationConfig`` from it. The JAX package's kernel knobs map to the
    port's ``kernel_*`` knobs; those the port has no use for are logged as
    ignored, and ``pallas_group_skip: true`` raises."""
    config = Configurator.load(args.config)
    optimization = config.get("optimization", {})
    volume = config.get("volume_rendering", {})
    weights = config.get("loss_weights", {})
    surface = config.get("surface_rendering", {})
    knobs = {}
    for name, port_name in KERNEL_KNOBS.items():
        if name not in optimization:
            continue
        if port_name is None:
            if logger is not None:
                logger.info(f"config optimization.{name} is a knob of the JAX package only; "
                            "ignored")
        else:
            knobs[port_name] = optimization[name]
    if knobs.get("kernel_group_skip"):
        raise NotImplementedError("pallas_group_skip: per-tile instance-group skipping is not "
                                  "ported")
    cfg = opt.OptimizationConfig(
        num_steps=optimization.get("num_steps", 3000),
        warmup_steps=optimization.get("warmup_steps", 1000),
        num_rays=volume.get("num_rays", 1000),
        num_samples=volume.get("num_fine_samples", 100),
        distance_range=tuple(volume.get("distance_range", (0.0, 100.0))),
        max_sdf_union_temperature=volume.get("max_sdf_union_temperature", 1.0),
        min_sdf_union_temperature=volume.get("min_sdf_union_temperature", 0.1),
        max_sdf_std_deviation=volume.get("max_sdf_std_deviation", 1.0),
        min_sdf_std_deviation=volume.get("min_sdf_std_deviation", 0.1),
        iou_projection_weight=weights.get("iou_projection_loss", 0.1),
        l1_projection_weight=weights.get("l1_projection_loss", 1.0),
        silhouette_weight=weights.get("silhouette_loss", 1.0),
        eikonal_weight=weights.get("eikonal_loss", 0.01),
        photometric_weight=weights.get("photometric_loss", 0.0),
        surface_num_rays=surface.get("num_rays", 100),
        surface_num_iterations=surface.get("num_iterations", 1000),
        surface_convergence_criteria=surface.get("convergence_criteria", 0.01),
        surface_bounding_radius=surface.get("bounding_radius", 100.0),
        checkpoint_interval=config.get("logging", {}).get("ckpt_intervals", 500),
        **knobs,
    )
    return cfg, config


def make_dataset(config):
    datasets_cfg = config.get("datasets", {}).get("train")
    if datasets_cfg is not None and "function" in datasets_cfg:
        return instantiate(datasets_cfg)
    return KITTI360Dataset(filenames=config["filenames"],
                           num_source_frames=config.get("num_source_frames", 16))


def frame_seed(global_seed: int, shard: int, index: int) -> int:
    """A frame's integer seed, a pure function of the run's global seed,
    the process's shard (0 unless ``random.use_unique_seed``) and the
    frame's index in the dataset: ``((global_seed + shard) * 1_000_003 +
    index) mod (2^31 - 1)``. It seeds the frame's initial parameters and,
    with the step, every step's random stream (``optimize.step_generator``),
    so a frame resumed at step s continues its uninterrupted run exactly.
    (The JAX driver folds the index into a PRNG key instead.)"""
    return ((int(global_seed) + int(shard)) * 1_000_003 + int(index)) % (2**31 - 1)


class _FrameJob:
    """Per-frame host-side state for the (possibly batched) optimizer."""

    def __init__(self, frame, image_filename, ckpt_dirname, log_dirname, seed):
        self.frame = frame
        self.image_filename = image_filename
        self.saver = Saver(ckpt_dirname)
        self.writer = SummaryWriter(log_dirname) if SummaryWriter else None
        self.seed = seed

    def save_and_log(self, step, params, scalars, cfg, config, meters, logger, opt_state=None):
        """``params``/``scalars`` are this frame's slices (no frame axis)."""
        scalar_every = config.get("logging", {}).get("scalar_intervals", 50)
        image_every = config.get("logging", {}).get("image_intervals", 500)
        jax_params = convert.params_to_jax(params)
        entries = dict(
            step=np.asarray(step - 1),
            models={"detector": jax_params["boxes"],
                    "hyper_distance_field": jax_params["hyper"]},
            metrics={k: np.asarray(v[-1]) for k, v in scalars.items()},
            valid=self.frame.valid.cpu().numpy(),
        )
        if opt_state is not None and step < cfg.num_steps:
            # the Adam state rides along so that a preempted frame resumes
            # from its last checkpoint; the final checkpoint, which the
            # prediction tools read for every frame, goes without it
            entries["opt_state"] = convert.adam_state_to_jax(opt_state)
        self.saver.save(f"step_{step - 1}", **entries)
        base = step - len(scalars["loss"])
        if self.writer is not None:
            for offset in range(scalar_every - 1, len(scalars["loss"]), scalar_every):
                for name, values in scalars.items():
                    self.writer.add_scalar(f"scalars/{name}", float(values[offset]),
                                           base + offset)
            if step % image_every == 0:
                # GT masks, wireframes and ray dots per view, the predicted
                # masks and wireframes, the BEV
                panels.write_panels(
                    self.writer, panels.diagnostic_panels(params, self.frame, step - 1, cfg),
                    step)
        logger.info(
            f"[{self.image_filename}] step {step}/{cfg.num_steps} "
            f"loss={float(scalars['loss'][-1]):.4f} "
            f"iou_3d={float(scalars['iou_3d'][-1]):.4f} "
            f"progress={meters.progress():.2%}"
        )

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _resume_state(job, cfg, logger):
    """``(params, opt_state, start_step)`` from the frame's latest partial
    checkpoint (the port's or the JAX package's), or None. The parameters,
    the Adam state and the step carry over exactly and the step's random
    stream is a pure function of (seed, step), so the frame continues its
    uninterrupted run. A frame preempted in the middle of a batch resumes
    alone: its state carries over exactly, but its random stream is its own
    seed's, not the batch's."""
    steps = sorted(
        int(m.group(1))
        for p in glob.glob(os.path.join(job.saver.dirname, "step_*.npz"))
        if (m := re.search(r"step_(\d+)\.npz$", p))
    )
    if not steps or steps[-1] >= cfg.num_steps - 1:
        return None
    device = job.frame.device
    # newest first; an unreadable checkpoint falls back to the one before
    for latest in reversed(steps):
        try:
            payload = job.saver.load(f"step_{latest}")
        except PermissionError:
            # the environment's fault, not a damaged file: falling back would
            # restart every frame and discard finished work
            raise
        except (zipfile.BadZipFile, ValueError, KeyError, EOFError, OSError) as error:
            logger.warning(f"[{job.image_filename}] unreadable checkpoint step_{latest}: "
                           f"{error}; trying earlier")
            continue
        if "opt_state" not in payload:
            return None
        params = convert.params_from_jax(
            {"boxes": payload["models"]["detector"],
             "hyper": payload["models"]["hyper_distance_field"]}, device)
        opt_state = convert.adam_state_from_jax(payload["opt_state"], device)
        logger.info(f"[{job.image_filename}] resuming from step_{latest} "
                    f"({latest + 1}/{cfg.num_steps} steps done)")
        return params, opt_state, latest + 1
    return None


def _run_single(job, cfg, config, meters, stop_watch, logger, init_state=None):
    start = init_state[2] if init_state is not None else 0
    if start:
        # steps already done count toward progress, with no duration sample
        meters.update(count=start)
        stop_watch.restart()
    last = {"step": start}

    def callback(step, params, scalars, opt_state):
        covered = step - last["step"]
        last["step"] = step
        meters.update(count=covered, optimize=stop_watch.restart())
        job.save_and_log(step, params, scalars, cfg, config, meters, logger, opt_state=opt_state)

    opt.optimize_frame(job.frame, job.seed, cfg, callback=callback, init_state=init_state)
    job.close()


def _run_jobs(jobs, cfg, config, meters, stop_watch, logger):
    """Optimize a bucket of equally shaped frames (co-optimized when >1)."""
    # preempted frames resume one by one; fresh ones co-optimize as a batch
    resumes, fresh = [], []
    for job in jobs:
        state = _resume_state(job, cfg, logger)
        (resumes if state is not None else fresh).append((job, state))
    for job, state in resumes:
        _run_single(job, cfg, config, meters, stop_watch, logger, state)
    jobs = [job for job, _ in fresh]
    if not jobs:
        return
    if len(jobs) == 1:
        _run_single(jobs[0], cfg, config, meters, stop_watch, logger)
        return

    frames = sharded.stack_frames([job.frame for job in jobs])
    last = {"step": 0}

    def callback(step, params, scalars, opt_state):
        covered = (step - last["step"]) * len(jobs)
        last["step"] = step
        meters.update(count=covered, optimize=stop_watch.restart())
        for f, job in enumerate(jobs):
            # mu/nu carry the frame axis; the step count is shared by the batch
            opt_f = {"mu": opt.tree_map(lambda t: t[f], opt_state["mu"]),
                     "nu": opt.tree_map(lambda t: t[f], opt_state["nu"]),
                     "count": opt_state["count"]}
            job.save_and_log(step, opt.tree_map(lambda t: t[f], params),
                             {k: v[:, f] for k, v in scalars.items()}, cfg, config, meters,
                             logger, opt_state=opt_f)

    # co-optimized frames share the first frame's seed: one random stream
    # whose draws are shaped [F, ...], independent per frame
    opt.optimize_frames_batched(frames, jobs[0].seed, cfg, callback=callback)
    for job in jobs:
        job.close()


def train(args):
    device = torch.device(args.device)
    parallel.initialize(args.launcher, backend="gloo" if device.type == "cpu" else None)
    logger = parallel.get_logger("vsrd_tpu_torch.main", rank_zero_only=False)
    cfg, config = build_config(args, logger)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dataset = make_dataset(config)
    # pixels are decoded only for the photometric branch, their only reader
    read_images = cfg.photometric_weight > 0.0
    if read_images:
        dataset.read_images = True
    shard = parallel.process_index() if args.shard is None else args.shard
    num_shards = parallel.process_count() if args.num_shards is None else args.num_shards
    indices = parallel.shard_indices(len(dataset), shard, num_shards)
    logger.info(f"process {shard}/{num_shards}: {len(indices)} of {len(dataset)} target "
                f"frames on {device}")

    # frames_per_batch > 1 co-optimizes frames of one shape on one card
    # (one launch of each field kernel with a frame grid axis)
    frames_per_batch = int(config.get("optimization", {}).get("frames_per_batch", 1))
    random_cfg = config.get("random", {})
    global_seed = random_cfg.get("global_seed", 0)
    seed_shard = shard if random_cfg.get("use_unique_seed", True) else 0

    config_dirname = os.path.dirname(args.config)
    meters = ProgressMeter(len(indices) * cfg.num_steps)
    stop_watch = StopWatch()
    stop_watch.start()
    run_start = time.time()
    pending = {}  # bucket -> [_FrameJob]

    def dirnames(image_filename):
        root_dirname = dataset.get_root_dirname(image_filename)
        image_dirname = os.path.splitext(os.path.relpath(image_filename, root_dirname))[0]
        return (os.path.join(config_dirname.replace("configs", "ckpts"), image_dirname),
                os.path.join(config_dirname.replace("configs", "logs"), image_dirname))

    for index in indices:
        # a finished frame is skipped before its data is loaded
        listed = dataset.image_filenames[int(index)][0]
        if has_final_checkpoint(dirnames(listed)[0], cfg.num_steps):
            logger.warning(f"[{listed}] already optimized, skipping")
            continue
        load_start = time.perf_counter()
        samples = dataset[int(index)]
        target = samples[0]
        image_filename = target["filename"]
        ckpt_dirname, log_dirname = dirnames(image_filename)
        if has_final_checkpoint(ckpt_dirname, cfg.num_steps):
            logger.warning(f"[{image_filename}] already optimized, skipping")
            continue
        num_instances = len(target["instance_ids"])
        if not num_instances:
            logger.warning(f"[{image_filename}] no instances, skipping")
            continue

        os.makedirs(log_dirname, exist_ok=True)
        with open(os.path.join(log_dirname, "config.json"), "w") as file:
            json.dump(config, file, indent=4)

        frame_kwargs = align_to_target(samples, max_instances=round_up_instances(num_instances))
        images = [samples[rel]["image"] for rel in sorted(samples)] if read_images else None
        frame = frame_mod.build_frame_data(images, **frame_kwargs, device=device)
        logger.info(f"[{image_filename}] loaded {frame.num_views} views at "
                    f"{frame.image_size[0]}x{frame.image_size[1]}, {num_instances} instances "
                    f"in bucket {frame.max_instances}: "
                    f"{time.perf_counter() - load_start:.3f} s")

        job = _FrameJob(frame, image_filename, ckpt_dirname, log_dirname,
                        frame_seed(global_seed, seed_shard, index))
        bucket = (frame.max_instances, frame.num_views, frame.image_size)
        pending.setdefault(bucket, []).append(job)
        if len(pending[bucket]) >= frames_per_batch:
            _run_jobs(pending.pop(bucket), cfg, config, meters, stop_watch, logger)

    for jobs in pending.values():
        _run_jobs(jobs, cfg, config, meters, stop_watch, logger)
    logger.info(f"done in {time.time() - run_start:.1f}s")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: volumetric silhouette rendering auto-labeler")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--launcher", type=str, default=None, choices=["torchrun", "slurm"],
                        help="read the process group from torchrun's or Slurm's environment "
                             "(by default from whichever is set; one process if neither)")
    parser.add_argument("--shard", type=int, default=None,
                        help="explicit frame-shard index (defaults to the process index); "
                             "lets independent processes split the frame list without a "
                             "process group")
    parser.add_argument("--num_shards", type=int, default=None,
                        help="explicit shard count (defaults to the process count)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card of the process's local rank) or 'cpu'")
    args = parser.parse_args(argv)
    if args.train:
        train(args)


if __name__ == "__main__":
    main()
