"""Train a DETR3D detector on the auto-labeler's pseudo-labels.

Counterpart of ``scripts/train_detector.py``, with its flags and defaults
and ``--device`` (default ``cuda``): prediction JSONs
(``tools/kitti_360/make_predictions``) and their images -> the port's
DETR3D (``--arch deformable``, or ``--deformable`` as before:
DeformableDETR3D), AdamW, an AP / KITTI AP|R40 evaluation on a held-out
split at ``eval_intervals`` and at the end, and checkpoints in the JAX package's layout (``models={"detector": <flax
tree>}``, ``step``, ``config``). ``--arch detr-r50`` trains DETR at its
published widths (``PublishedDETR3D``: ResNet-50, 6 + 6 layers of 256, 100
queries) by its recipe (AdamW at ``--learning_rate`` and 1e-5 for the
trained backbone, gradients clipped to norm 0.1, the loss on all six
decoder levels); the width flags default to the architecture's, and its
checkpoints hold the port's ``state_dict`` under ``models.detector`` (the
JAX package has no such model). Images are decoded and resized without
PIL (``data/png.py``, ``transforms.resize_pil_bilinear``, PIL's BILINEAR
byte for byte) and memoized.

Under torchrun (or Slurm) each process takes its share of the global batch
and the model trains under DistributedDataParallel
(``pipeline/detector_training.py``); the first process evaluates and
writes the checkpoints.

Usage:
    python -m vsrd_tpu_torch.scripts.train_detector --root_dirname datasets/KITTI-360 \\
        --ckpt_dirname ckpts/kitti_360/vsrd --out_dirname ckpts/detr3d \\
        --num_steps 10000 --batch_size 8 [--arch deformable | --arch detr-r50]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import time

import numpy as np
import torch

from ..data import png, transforms
from ..models import detr3d
from ..parallel import distributed as parallel
from ..pipeline import detector_eval
from ..pipeline import detector_training as dt
from ..utils import convert
from ..utils.saver import Saver

# the width flags' defaults by architecture: the JAX CLI's, and DETR's published ones
JAX_WIDTHS = {"num_queries": 50, "hidden_dim": 128, "num_encoder_layers": 2,
              "num_decoder_layers": 2, "num_heads": 8}
WIDTHS = {
    "detr3d": JAX_WIDTHS,
    "deformable": JAX_WIDTHS,
    "detr-r50": {"num_queries": 100, "hidden_dim": 256, "num_encoder_layers": 6,
                 "num_decoder_layers": 6, "num_heads": 8},
}


def build_index(root_dirname, ckpt_name):
    """(image, prediction, annotation) path triples for every frame that
    has a pseudo-label JSON."""
    prediction_dirname = os.path.join("predictions", ckpt_name)
    triples = []
    for prediction_filename in sorted(glob.glob(os.path.join(
            root_dirname, prediction_dirname, "*", "image_00", "data_rect", "*.json"))):
        image_filename = prediction_filename.replace(
            prediction_dirname, "data_2d_raw").replace(".json", ".png")
        annotation_filename = prediction_filename.replace(prediction_dirname, "annotations")
        if os.path.exists(image_filename) and os.path.exists(annotation_filename):
            triples.append((image_filename, prediction_filename, annotation_filename))
    return triples


def load_example(paths, image_size, max_boxes, class_names, confidence_threshold):
    """One training example: the resized image (NHWC in [0, 1]), K rescaled
    to it, per-class labels, normalized-xyxy 2D boxes and camera-space 3D
    corners, highest confidence first, padded to ``max_boxes`` with a
    validity mask."""
    image_filename, prediction_filename, annotation_filename = paths
    pixels = png.read_rgb(image_filename)
    src_h, src_w = pixels.shape[:2]
    h, w = image_size
    image = transforms.resize_pil_bilinear(pixels, (h, w)).astype(np.float32) / 255.0

    with open(annotation_filename) as file:
        annotation = json.load(file)
    intrinsic = np.asarray(annotation["intrinsic_matrix"], np.float32)
    intrinsic = np.diag([w / src_w, h / src_h, 1.0]).astype(np.float32) @ intrinsic

    with open(prediction_filename) as file:
        prediction = json.load(file)

    labels = np.zeros((max_boxes,), np.int32)
    boxes_2d = np.zeros((max_boxes, 4), np.float32)
    boxes_3d = np.zeros((max_boxes, 8, 3), np.float32)
    heights_px = np.zeros((max_boxes,), np.float32)
    valid = np.zeros((max_boxes,), bool)
    scale = np.asarray([src_w, src_h, src_w, src_h], np.float32)
    index = 0
    for class_index, class_name in enumerate(class_names):
        b2 = prediction["boxes_2d"].get(class_name, [])
        b3 = prediction["boxes_3d"].get(class_name, [])
        conf = prediction["confidences"].get(class_name, [1.0] * len(b3))
        if not (len(b2) == len(b3) == len(conf)):
            raise ValueError(
                f"{prediction_filename}: ragged prediction entry for {class_name!r}: "
                f"{len(b2)} boxes_2d, {len(b3)} boxes_3d, {len(conf)} confidences")
        # highest confidence first, so that the max_boxes cap drops the weakest
        order = np.argsort(np.asarray(conf, np.float32))[::-1]
        for i in order:
            if index >= max_boxes or conf[i] < confidence_threshold:
                continue
            # raw front-clipped projections extend past the image for
            # truncated cars; the sigmoid 2D head lives in [0, 1]
            box2 = np.clip(np.asarray(b2[i], np.float32).reshape(-1), 0.0, scale)
            boxes_2d[index] = box2 / scale
            boxes_3d[index] = np.asarray(b3[i], np.float32)
            # pixel height at the original resolution: what the KITTI
            # difficulty bins threshold (40 px / 25 px)
            heights_px[index] = box2[3] - box2[1]
            labels[index] = class_index
            valid[index] = True
            index += 1
    return {
        "images": image,
        "intrinsics": intrinsic,
        "labels": labels,
        "boxes_2d": boxes_2d,
        "boxes_3d": boxes_3d,
        "gt_heights_px": heights_px,
        "orig_sizes": np.asarray([src_h, src_w], np.float32),
        "valid": valid,
    }


def _example(paths, args, cache):
    if paths not in cache:
        cache[paths] = load_example(paths, (args.height, args.width), args.max_boxes,
                                    args.class_names, args.confidence_threshold)
    return cache[paths]


def _stack(examples, device):
    return {key: torch.from_numpy(np.stack([e[key] for e in examples])).to(device)
            for key in examples[0]}


def make_batch(triples, rng, args, cache, device="cpu", shard=0, num_shards=1):
    """A random global batch of ``batch_size`` frames (the same draw on every
    process), this process's contiguous share of it as tensors on
    ``device``. Decoded examples are memoized: the pseudo-labeled frames are
    few and small at training resolution."""
    picks = [triples[rng.randrange(len(triples))] for _ in range(args.batch_size)]
    per = args.batch_size // num_shards
    examples = [_example(p, args, cache) for p in picks[shard * per:(shard + 1) * per]]
    return _stack(examples, device)


def eval_batches(eval_triples, args, cache, device):
    """The eval split's first ``eval_frames`` frames in whole batches (a
    ragged last batch is dropped), or one ragged batch when there are
    fewer frames than a batch."""
    picks = eval_triples[:args.eval_frames]
    batches = [_stack([_example(p, args, cache) for p in picks[i:i + args.batch_size]], device)
               for i in range(0, len(picks) - args.batch_size + 1, args.batch_size)]
    return batches or [_stack([_example(p, args, cache) for p in picks], device)]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dirname", required=True)
    parser.add_argument("--ckpt_dirname", required=True,
                        help="VSRD checkpoint dir whose basename names the predictions/ "
                             "subtree (as make_predictions)")
    parser.add_argument("--out_dirname", default="ckpts/detr3d")
    parser.add_argument("--class_names", nargs="+", default=["car"])
    parser.add_argument("--num_steps", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="global batch; must divide by the process count")
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--width", type=int, default=704)
    parser.add_argument("--max_boxes", type=int, default=16)
    parser.add_argument("--confidence_threshold", type=float, default=0.3)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--arch", choices=tuple(WIDTHS), default="detr3d",
                        help="detr3d: the JAX package's DETR3D; deformable: its deformable "
                             "variant; detr-r50: DETR at its published widths and recipe")
    for name in WIDTHS["detr3d"]:
        parser.add_argument(f"--{name}", type=int, default=None,
                            help="default: the architecture's (detr3d "
                                 f"{WIDTHS['detr3d'][name]}, detr-r50 {WIDTHS['detr-r50'][name]})")
    parser.add_argument("--deformable", dest="arch", action="store_const", const="deformable",
                        help="--arch deformable")
    parser.add_argument("--log_intervals", type=int, default=50)
    parser.add_argument("--ckpt_intervals", type=int, default=1000)
    parser.add_argument("--eval_intervals", type=int, default=1000,
                        help="AP/matched-IoU eval cadence (0 disables)")
    parser.add_argument("--holdout_fraction", type=float, default=0.1,
                        help="fraction of frames held out for eval (0: evaluate on the "
                             "training frames)")
    parser.add_argument("--eval_frames", type=int, default=64, help="max frames per eval pass")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card of the process's local rank) or 'cpu'")
    args = parser.parse_args(argv)
    for name, value in WIDTHS[args.arch].items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    return args


def main(argv=None):
    """Train; returns ``{"losses", "step_seconds", "eval", "eval_seconds",
    "checkpoint"}`` (the per-step global loss and wall time, the last
    evaluation's metrics and time, the final checkpoint's path)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here (pass --device cpu to train on "
                           "the CPU)")
    parallel.initialize(backend="gloo" if device.type == "cpu" else None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = parallel.process_index(), parallel.process_count()
    if args.batch_size % world:
        raise SystemExit(f"--batch_size {args.batch_size} does not divide by {world} processes")

    triples = build_index(args.root_dirname, os.path.basename(args.ckpt_dirname))
    if not triples:
        raise SystemExit(f"no prediction JSONs under {args.root_dirname}/predictions/"
                         f"{os.path.basename(args.ckpt_dirname)}: run "
                         "python -m vsrd_tpu_torch.tools.kitti_360.make_predictions first")
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"{len(triples)} pseudo-labeled frames", flush=True)

    # deterministic holdout split for the eval signal
    shuffled = list(triples)
    random.Random(args.seed + 1).shuffle(shuffled)
    n_hold = int(len(shuffled) * args.holdout_fraction)
    eval_triples = shuffled[:n_hold] or shuffled
    triples = shuffled[n_hold:] or shuffled
    if args.eval_intervals:
        log(f"train {len(triples)} / eval {len(eval_triples)} frames "
            f"({'holdout' if n_hold else 'train set'})", flush=True)
    log(f"data parallel over {world} process(es) on {device}", flush=True)

    published = args.arch == "detr-r50"
    model = detr3d.make_detector(
        args.arch, seed=args.seed, device=device,
        num_classes=len(args.class_names), num_queries=args.num_queries,
        hidden_dim=args.hidden_dim, num_encoder_layers=args.num_encoder_layers,
        num_decoder_layers=args.num_decoder_layers, num_heads=args.num_heads)
    model_name = type(model).__name__
    model, optimizer = dt.create_train_state(model, args.learning_rate, device)
    step_fn = dt.make_train_step(model, optimizer, num_classes=len(args.class_names))

    saver = Saver(args.out_dirname)
    rng = random.Random(args.seed)
    cache = {}
    history = {"losses": [], "step_seconds": [], "eval": None, "eval_seconds": None}
    config = {k: v for k, v in vars(args).items() if v is not None} | {"model": model_name}

    def run_eval(step):
        start = time.perf_counter()
        metrics = detector_eval.evaluate_model(
            dt.unwrap(model), eval_batches(eval_triples, args, cache, device),
            num_classes=len(args.class_names))
        history["eval"], history["eval_seconds"] = metrics, time.perf_counter() - start
        parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in sorted(metrics.items()))
        print(f"eval step {step + 1}: {parts}", flush=True)

    for step in range(args.num_steps):
        start = time.perf_counter()
        batch = make_batch(triples, rng, args, cache, device, rank, world)
        loss, aux = step_fn(batch)
        history["losses"].append(float(loss))
        history["step_seconds"].append(time.perf_counter() - start)
        if (step + 1) % args.log_intervals == 0 or step == 0:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(aux.items()))
            log(f"step {step + 1}/{args.num_steps} loss={float(loss):.4f} {parts}", flush=True)
        last = step + 1 == args.num_steps
        if rank == 0 and args.eval_intervals and ((step + 1) % args.eval_intervals == 0 or last):
            run_eval(step)
        if rank == 0 and ((step + 1) % args.ckpt_intervals == 0 or last):
            state = dt.unwrap(model).state_dict()
            saver.save(
                f"step_{step}",
                step=np.asarray(step),
                models={"detector": state if published
                        else convert.detector_params_to_jax(state, args.num_heads)},
                config=config,
            )
    parallel.barrier()
    history["checkpoint"] = saver.path(f"step_{args.num_steps - 1}.npz")
    log(f"saved {history['checkpoint']}", flush=True)
    return history


if __name__ == "__main__":
    main()
