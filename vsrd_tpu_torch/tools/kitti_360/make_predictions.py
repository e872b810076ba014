"""Optimized checkpoints -> pseudo-label JSONs.

Counterpart of ``tools/kitti_360/make_predictions.py``, with its CLI and
files (``python -m vsrd_tpu_torch.tools.kitti_360.make_predictions``), over
the labeling driver's ``.npz`` checkpoints (the port's or the JAX
package's; host tooling, on the CPU): rebuild the box parameters,
re-derive the gravity rectification from the target annotation, project
the world boxes into every frame of the instance group, and set each
instance's confidence to the group-averaged 2D IoU between its projected
box and the mask-derived GT box after Hungarian matching.

Output: per-frame JSON
``{"boxes_3d": {class: [[8x3]...]}, "boxes_2d": {class: [[2x2]...]},
"confidences": {class: [...]}}`` under
``predictions/<ckpt_dirname_basename>/``.
"""

import argparse
import functools
import glob
import json
import multiprocessing
import os

import numpy as np
import scipy.optimize
import torch

from ...data import rle
from ...data.kitti360 import rectification_matrix_np
from ...data.transforms import MaskRefiner
from ...models import box_parameters
from ...ops import geometry
from ...utils.saver import load_checkpoint


def _pairwise_iou(boxes1, boxes2):
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = area1[:, None] + area2[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _masks_to_boxes(masks):
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, mask in enumerate(masks):
        ys, xs = np.nonzero(mask > 0.5)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes


def decode_world_boxes(checkpoint):
    """Checkpoint -> decoded world-space 8-corner boxes [N, 8, 3]."""
    boxes = checkpoint["models"]["detector"]
    params = {k: torch.as_tensor(np.asarray(v)) for k, v in boxes.items()}
    with torch.no_grad():
        decoded = box_parameters.decode_boxes(params)
    return decoded["boxes_3d"].numpy().reshape(-1, 8, 3)


def make_predictions(sequence, root_dirname, ckpt_dirname, ckpt_filename,
                     split_dirname, class_names):
    split_dir = os.path.join(root_dirname, "filenames", split_dirname, sequence)
    group_filename = os.path.join(split_dir, "grouped_image_filenames.txt")
    sample_filename = os.path.join(split_dir, "sampled_image_filenames.txt")
    if not (os.path.exists(group_filename) and os.path.exists(sample_filename)):
        return

    with open(group_filename) as file:
        grouped = {
            tuple(line.split(" ")[0].split(",")): line.split(" ")[1].split(",")
            for line in map(str.strip, file)
            if line
        }
    with open(sample_filename) as file:
        sampled = {
            tuple(line.split(" ")[0].split(",")): line.split(" ")[1]
            for line in map(str.strip, file)
            if line
        }

    refiner = MaskRefiner()

    for instance_ids, group_filenames in grouped.items():
        target_image_filename = sampled.get(instance_ids)
        if target_image_filename is None:
            continue
        target_image_dirname = os.path.splitext(
            os.path.relpath(target_image_filename, root_dirname)
        )[0]
        target_ckpt = os.path.join(
            ckpt_dirname, sequence, target_image_dirname, ckpt_filename
        )
        if not os.path.exists(target_ckpt):
            print(f"[{target_ckpt}] does not exist")
            continue

        checkpoint = load_checkpoint(target_ckpt)
        world_boxes = decode_world_boxes(checkpoint)
        # drop padded instances if the checkpoint stores a validity mask
        valid = checkpoint.get("valid")
        if valid is not None:
            world_boxes = world_boxes[np.asarray(valid, bool)]
        world_h = np.pad(
            world_boxes, ((0, 0), (0, 0), (0, 1)), constant_values=1.0
        )

        target_annotation_filename = target_image_filename.replace(
            "data_2d_raw", "annotations"
        ).replace(".png", ".json")
        with open(target_annotation_filename) as file:
            target_annotation = json.load(file)
        target_extrinsic = np.asarray(
            target_annotation["extrinsic_matrix"], np.float64
        )
        inv_target = np.linalg.inv(target_extrinsic)
        rect = rectification_matrix_np(target_extrinsic.astype(np.float32))
        rect4 = np.eye(4)
        rect4[:3, :3] = rect.T

        target_instance_ids = [
            int(i)
            for class_name, masks in target_annotation["masks"].items()
            if class_name in class_names
            for i in masks.keys()
        ]

        n_pd = len(world_boxes)
        n_gt = len(target_instance_ids)
        iou_sum = np.zeros((n_pd, n_gt))
        iou_cnt = np.zeros((n_pd, n_gt))
        callbacks = []

        for source_image_filename in group_filenames:
            source_annotation_filename = source_image_filename.replace(
                "data_2d_raw", "annotations"
            ).replace(".png", ".json")
            if not os.path.exists(source_annotation_filename):
                continue
            with open(source_annotation_filename) as file:
                source_annotation = json.load(file)

            k = np.asarray(source_annotation["intrinsic_matrix"], np.float64)
            e = np.asarray(source_annotation["extrinsic_matrix"], np.float64)
            e = e @ inv_target @ rect4

            cam = world_h @ e.T
            cam_boxes = cam[..., :3] / cam[..., 3:]

            boxes_2d = np.asarray(
                [
                    geometry.project_box_3d(
                        torch.as_tensor(box, dtype=torch.float32),
                        torch.as_tensor(k, dtype=torch.float32),
                    ).numpy()
                    for box in cam_boxes
                ]
            )

            source_masks = [
                rle.decode(mask).astype(np.float32)
                for class_name, masks in source_annotation["masks"].items()
                if class_name in class_names
                for mask in masks.values()
            ]
            if not source_masks:
                continue
            source_masks = refiner({"masks": np.stack(source_masks)})["masks"]
            gt_boxes = _masks_to_boxes(source_masks)

            h, w = source_masks.shape[-2:]
            pd_flat = boxes_2d.reshape(-1, 4).copy()
            pd_flat[:, 0::2] = np.clip(pd_flat[:, 0::2], 0, w)
            pd_flat[:, 1::2] = np.clip(pd_flat[:, 1::2], 0, h)

            iou = _pairwise_iou(pd_flat, gt_boxes)

            source_ids = [
                int(i)
                for class_name, masks in source_annotation["masks"].items()
                if class_name in class_names
                for i in masks.keys()
            ]
            gt_index = {tid: j for j, tid in enumerate(target_instance_ids)}
            for s_col, sid in enumerate(source_ids):
                t_col = gt_index.get(sid)
                if t_col is None:
                    continue
                iou_sum[:, t_col] += iou[:, s_col]
                iou_cnt[:, t_col] += 1

            prediction_dirname = os.path.join(
                "predictions", os.path.basename(ckpt_dirname)
            )
            prediction_filename = source_annotation_filename.replace(
                "annotations", prediction_dirname
            )

            def save(filename, boxes_3d, boxes_2d, confidences):
                os.makedirs(os.path.dirname(filename), exist_ok=True)
                with open(filename, "w") as file:
                    json.dump(
                        {
                            "boxes_3d": {"car": boxes_3d.tolist()},
                            "boxes_2d": {"car": boxes_2d.tolist()},
                            "confidences": {"car": confidences.tolist()},
                        },
                        file,
                        indent=4,
                    )

            callbacks.append(
                functools.partial(
                    save,
                    filename=prediction_filename,
                    boxes_3d=cam_boxes,
                    boxes_2d=boxes_2d,
                )
            )

        with np.errstate(invalid="ignore"):
            averaged = np.where(iou_cnt > 0, iou_sum / np.maximum(iou_cnt, 1), 0.0)
        if averaged.size:
            rows, cols = scipy.optimize.linear_sum_assignment(averaged, maximize=True)
            confidences = np.zeros(n_pd, np.float32)
            confidences[rows] = averaged[rows, cols]
        else:
            confidences = np.zeros(n_pd, np.float32)

        for callback in callbacks:
            callback(confidences=confidences)


def main(args):
    sequences = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(args.root_dirname, "data_2d_raw", "*"))
    )
    worker = functools.partial(
        make_predictions,
        root_dirname=args.root_dirname,
        ckpt_dirname=args.ckpt_dirname,
        ckpt_filename=args.ckpt_filename,
        split_dirname=args.split_dirname,
        class_names=args.class_names,
    )
    if args.num_workers > 1:
        with multiprocessing.Pool(args.num_workers) as pool:
            for _ in pool.imap_unordered(worker, sequences):
                pass
    else:
        for sequence in sequences:
            worker(sequence)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: Prediction Maker for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--ckpt_dirname", type=str, default="ckpts/kitti_360/vsrd")
    parser.add_argument("--ckpt_filename", type=str, default="step_2999.npz")
    parser.add_argument("--split_dirname", type=str, default="R50-N16-M128-B16")
    parser.add_argument("--class_names", type=str, nargs="+", default=["car"])
    parser.add_argument("--num_workers", type=int, default=1)
    main(parser.parse_args())
