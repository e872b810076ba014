"""Pseudo-label JSONs -> KITTI-format txt label files.

Counterpart of ``tools/kitti_360/convert_predictions.py``, with its CLI and
files (``python -m vsrd_tpu_torch.tools.kitti_360.convert_predictions``):
8-corner boxes are encoded to (location, dimensions, yaw), shifted to the
KITTI bottom-center convention, dims reordered to [h, w, l], alpha =
global yaw - ray angle. One line per object:

    type trunc occ alpha x0 y0 x1 y1 h w l x y z ry score
"""

import argparse
import functools
import glob
import json
import multiprocessing
import os

import numpy as np

from ...data import rle


def encode_box_3d_np(boxes_3d):
    """Corners [N, 8, 3] (evaluation order) -> (location, full dims, yaw).

    """
    boxes_3d = np.asarray(boxes_3d, np.float64)
    locations = boxes_3d.mean(axis=-2)

    def edge_mean(a, b):
        return np.linalg.norm(
            boxes_3d[:, a, :] - boxes_3d[:, b, :], axis=-1
        ).mean(axis=-1)

    widths = edge_mean([1, 2, 6, 5], [0, 3, 7, 4])
    heights = edge_mean([4, 5, 6, 7], [0, 1, 2, 3])
    lengths = edge_mean([1, 0, 4, 5], [2, 3, 7, 6])
    dimensions = np.stack([widths, heights, lengths], axis=-1)

    direction = (
        boxes_3d[:, [1, 0, 4, 5], :] - boxes_3d[:, [2, 3, 7, 6], :]
    ).mean(axis=-2)
    cos_sin = direction[:, [2, 0]]
    cos_sin /= np.maximum(np.linalg.norm(cos_sin, axis=-1, keepdims=True), 1e-12)
    yaw = np.arctan2(cos_sin[:, 1], cos_sin[:, 0])
    return locations, dimensions, yaw


def write_kitti_labels(filename, class_names, boxes_3d, boxes_2d, scores):
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    locations, dimensions, yaws = encode_box_3d_np(boxes_3d)
    with open(filename, "w") as file:
        for class_name, location, dimension, yaw, box_2d, score in zip(
            class_names, locations, dimensions, yaws, boxes_2d, scores
        ):
            # KITTI-3D conventions: bottom-centre y, [h, w, l], alpha
            location = location.copy()
            location[1] += dimension[1] / 2.0      # bottom-center y
            dimension = dimension[[1, 0, 2]]       # [h, w, l]
            ray = np.arctan2(location[0], location[2])
            global_yaw = yaw - np.pi / 2.0
            alpha = global_yaw - ray
            box_flat = np.asarray(box_2d).reshape(-1)
            file.write(
                f"{class_name.capitalize()} 0.0 0 {alpha} "
                f"{' '.join(map(str, box_flat.tolist()))} "
                f"{' '.join(map(str, dimension.tolist()))} "
                f"{' '.join(map(str, location.tolist()))} "
                f"{global_yaw} {score}\n"
            )


def convert_predictions(sequence, root_dirname, ckpt_dirname, class_names):
    prediction_dirname = os.path.join("predictions", os.path.basename(ckpt_dirname))
    prediction_filenames = sorted(
        glob.glob(
            os.path.join(
                root_dirname, prediction_dirname, sequence,
                "image_00", "data_rect", "*.json",
            )
        )
    )
    for prediction_filename in prediction_filenames:
        with open(prediction_filename) as file:
            prediction = json.load(file)

        pd_class_names = [
            class_name
            for class_name, boxes in prediction["boxes_3d"].items()
            for _ in boxes
        ]
        pd_boxes_3d = np.concatenate(
            [np.asarray(b, np.float32).reshape(-1, 8, 3)
             for b in prediction["boxes_3d"].values()] or [np.zeros((0, 8, 3))]
        )
        pd_boxes_2d = np.concatenate(
            [np.asarray(b, np.float32).reshape(-1, 2, 2)
             for b in prediction["boxes_2d"].values()] or [np.zeros((0, 2, 2))]
        )
        pd_scores = np.concatenate(
            [np.asarray(c, np.float32).reshape(-1)
             for c in prediction["confidences"].values()] or [np.zeros(0)]
        )

        annotation_filename = prediction_filename.replace(
            prediction_dirname, "annotations"
        )
        with open(annotation_filename) as file:
            annotation = json.load(file)

        gt_class_names, gt_boxes_3d, gt_masks = [], [], []
        for class_name, masks in annotation["masks"].items():
            if class_name not in class_names:
                continue
            boxes = annotation.get("boxes_3d", {}).get(class_name, {})
            for instance_id, mask_rle in masks.items():
                gt_class_names.append(class_name)
                gt_boxes_3d.append(
                    np.asarray(
                        boxes.get(instance_id, [[np.nan] * 3] * 8), np.float32
                    )
                )
                gt_masks.append(rle.decode(mask_rle))
        gt_boxes_3d = (
            np.stack(gt_boxes_3d) if gt_boxes_3d else np.zeros((0, 8, 3))
        )
        # frames with incomplete GT are skipped
        if not np.all(np.isfinite(gt_boxes_3d)):
            continue

        gt_boxes_2d = np.zeros((len(gt_masks), 2, 2), np.float32)
        for i, mask in enumerate(gt_masks):
            ys, xs = np.nonzero(mask)
            if len(ys):
                gt_boxes_2d[i] = [[xs.min(), ys.min()], [xs.max(), ys.max()]]

        label_dirname = os.path.join("labels", os.path.basename(ckpt_dirname))
        rel = os.path.splitext(os.path.relpath(prediction_filename, root_dirname))[0]
        write_kitti_labels(
            os.path.join(root_dirname, label_dirname, f"{rel}.txt"),
            pd_class_names, pd_boxes_3d, pd_boxes_2d, pd_scores,
        )
        rel = os.path.splitext(os.path.relpath(annotation_filename, root_dirname))[0]
        write_kitti_labels(
            os.path.join(root_dirname, label_dirname, f"{rel}.txt"),
            gt_class_names, gt_boxes_3d, gt_boxes_2d,
            np.ones(len(gt_class_names)),
        )


def main(args):
    sequences = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(args.root_dirname, "data_2d_raw", "*"))
    )
    worker = functools.partial(
        convert_predictions,
        root_dirname=args.root_dirname,
        ckpt_dirname=args.ckpt_dirname,
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
        description="vsrd_tpu_torch: Prediction Converter for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--ckpt_dirname", type=str, default="ckpts/kitti_360/vsrd")
    parser.add_argument("--class_names", type=str, nargs="+", default=["car"])
    parser.add_argument("--num_workers", type=int, default=1)
    main(parser.parse_args())
