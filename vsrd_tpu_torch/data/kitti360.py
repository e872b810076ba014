"""KITTI-360 multi-view auto-labeling dataset.

Counterpart of ``vsrd_tpu/data/kitti360.py``: host-side numpy loading of a
target frame and its source frames (COCO-RLE masks, 8-corner camera boxes,
K and E from each frame's annotation JSON), the driver's transform chains,
gravity rectification relative to the target frame, and ``align_to_target``,
which aligns the source views' instances to the target's instance ids and
pads them into the arrays of ``pipeline.frame.build_frame_data``. Source
frames load on a thread pool (the host work is file reads and native code).

Each sample carries its image's size, read from the PNG's IHDR header. The
pixels are decoded only with ``read_images`` (``data/png.py``, no PIL), for
the photometric branch, their only reader: the driver sets it when the
photometric loss weight is positive, as the JAX driver passes images only
then. The image is float32 in [0, 1], ``[H, W, C]``, and the transforms
resize it bilinearly with the masks.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import struct
from dataclasses import dataclass, field

import numpy as np

from . import png, rle
from .transforms import (
    BoxGenerator,
    BoxSizeFilter,
    MaskAreaFilter,
    MaskRefiner,
    Resizer,
    SoftRasterizer,
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_size(filename: str) -> tuple[int, int]:
    """(height, width) of a PNG, from its IHDR chunk."""
    with open(filename, "rb") as file:
        head = file.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{filename} is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return int(height), int(width)


def rectification_matrix_np(extrinsic_matrix: np.ndarray) -> np.ndarray:
    """Gravity rectification: the rotation about x that levels the camera's
    rounded y axis."""
    rot = extrinsic_matrix[:3, :3]
    x_axis, y_axis = rot[0], rot[1]
    y_round = np.round(y_axis)
    angle = np.arccos(np.clip(np.dot(y_round, y_axis), -1.0, 1.0)) * np.sign(
        np.dot(np.cross(y_round, y_axis), x_axis)
    )
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def default_transforms(image_size=(376, 1408), min_mask_area=1, target_min_mask_area=128,
                       min_box_size=1, target_min_box_size=16, target=False):
    """The shipped transform chains of the target and the source frames."""
    return [
        Resizer(image_size),
        MaskAreaFilter(min_mask_area),
        MaskRefiner(),
        MaskAreaFilter(target_min_mask_area if target else min_mask_area),
        BoxGenerator(),
        BoxSizeFilter(target_min_box_size if target else min_box_size),
        SoftRasterizer(),
    ]


@dataclass
class KITTI360Dataset:
    """Parses ``sampled_image_filenames.txt`` lines (``instance_ids
    target_path source_relative_indices``); item ``i`` is a dict from
    relative frame index (0 = the target) to that frame's sample."""

    filenames: list
    class_names: list = field(default_factory=lambda: ["car"])
    num_workers: int = 4
    num_source_frames: int = 2
    target_transforms: list = None
    source_transforms: list = None
    rectification: bool = True
    read_images: bool = False

    def __post_init__(self):
        self.image_filenames = []
        self.image_blacklist = set()
        for filename in self.filenames:
            with open(filename) as file:
                for line in file:
                    parts = line.strip().split(" ")
                    if len(parts) != 3:
                        continue
                    _, target_image_filename, source_relative_indices = parts
                    indices = list(map(int, source_relative_indices.split(",")))
                    self.image_filenames.append((target_image_filename, indices))
        if self.target_transforms is None:
            self.target_transforms = default_transforms(target=True)
        if self.source_transforms is None:
            self.source_transforms = default_transforms(target=False)

    @staticmethod
    def get_root_dirname(image_filename):
        for _ in range(5):
            image_filename = os.path.dirname(image_filename)
        return image_filename

    @staticmethod
    def get_annotation_filename(image_filename):
        return image_filename.replace("data_2d_raw", "annotations").replace(".png", ".json")

    @staticmethod
    def get_image_filename(image_filename, relative_index=0):
        frame_index = int(os.path.splitext(os.path.basename(image_filename))[0])
        return os.path.join(os.path.dirname(image_filename),
                            f"{frame_index + relative_index:010}.png")

    def read_annotation(self, annotation_filename):
        with open(annotation_filename) as file:
            annotation = json.load(file)

        intrinsic = np.asarray(annotation["intrinsic_matrix"], np.float32)
        extrinsic = np.asarray(annotation["extrinsic_matrix"], np.float32)

        masks_list, labels, boxes_3d, instance_ids = [], [], [], []
        for class_index, class_name in enumerate(self.class_names):
            class_masks = annotation["masks"].get(class_name, {})
            class_boxes = annotation.get("boxes_3d", {}).get(class_name, {})
            for instance_id, mask_rle in class_masks.items():
                masks_list.append(rle.decode(mask_rle).astype(np.float32))
                labels.append(class_index)
                boxes_3d.append(np.asarray(class_boxes.get(instance_id, [[np.nan] * 3] * 8),
                                           np.float32))
                instance_ids.append(int(instance_id))

        if masks_list:
            return dict(
                masks=np.stack(masks_list),
                labels=np.asarray(labels, np.int64),
                boxes_3d=np.stack(boxes_3d),
                instance_ids=np.asarray(instance_ids, np.int64),
                intrinsic_matrix=intrinsic,
                extrinsic_matrix=extrinsic,
            )
        return dict(intrinsic_matrix=intrinsic, extrinsic_matrix=extrinsic)

    def getitem(self, image_filename, transforms):
        h, w = png_size(image_filename)
        annotation = self.read_annotation(self.get_annotation_filename(image_filename))
        annotation.setdefault("masks", np.empty((0, h, w), np.float32))
        annotation.setdefault("labels", np.empty((0,), np.int64))
        annotation.setdefault("boxes_3d", np.empty((0, 8, 3), np.float32))
        annotation.setdefault("instance_ids", np.empty((0,), np.int64))

        sample = dict(annotation, image_size=(h, w), filename=image_filename)
        if self.read_images:
            sample["image"] = png.read_image(image_filename)
        for transform in transforms:
            sample = transform(sample)
        return sample

    def __len__(self):
        return len(self.image_filenames)

    def __getitem__(self, index):
        target_image_filename, source_relative_indices = self.image_filenames[index]

        if target_image_filename in self.image_blacklist:
            return self[random.randrange(len(self))]

        target_sample = self.getitem(target_image_filename, self.target_transforms)
        if not len(target_sample["masks"]):
            self.image_blacklist.add(target_image_filename)
            return self[random.randrange(len(self))]

        # evenly pick num_source_frames from the candidate list
        chunks = np.array_split(source_relative_indices, self.num_source_frames)
        picked = [c[len(c) // 2] for c in chunks if c.size]

        def load_source(relative_index):
            filename = self.get_image_filename(target_image_filename, int(relative_index))
            return int(relative_index), self.getitem(filename, self.source_transforms)

        samples = {0: target_sample}
        if self.num_workers > 1:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                for rel, sample in pool.map(load_source, picked):
                    samples[rel] = sample
        else:
            for rel in picked:
                rel, sample = load_source(rel)
                samples[rel] = sample
        samples = dict(sorted(samples.items()))

        if self.rectification:
            target_extrinsic = target_sample["extrinsic_matrix"]
            inv_target = np.linalg.inv(target_extrinsic)
            rect = rectification_matrix_np(target_extrinsic)
            rect4 = np.eye(4, dtype=np.float32)
            rect4[:3, :3] = rect.T
            for sample in samples.values():
                sample["extrinsic_matrix"] = sample["extrinsic_matrix"] @ inv_target @ rect4
                sample["rectification_matrix"] = rect
        return samples


def align_to_target(samples: dict, max_instances: int | None = None):
    """Align source-view instances to the target instance-id order and
    build the padded arrays for ``pipeline.frame.build_frame_data``.

    Returns its keyword arguments (all but the images)."""
    relative_indices = sorted(samples.keys())
    target = samples[0]
    target_ids = target["instance_ids"]
    n = len(target_ids)
    n_pad = max_instances or n

    soft_masks, gt_boxes_2d, visible = [], [], []
    intrinsics, extrinsics = [], []
    h, w = target["image_size"]

    for rel in relative_indices:
        sample = samples[rel]
        source_ids = list(sample["instance_ids"])
        index_of = {int(i): k for k, i in enumerate(source_ids)}
        indices = np.asarray([index_of.get(int(i), -1) for i in target_ids], np.int64)
        vis = indices >= 0

        def take(array, fill_shape):
            padded = np.zeros((n_pad, *fill_shape), np.float32)
            if len(array):
                safe = np.where(vis, indices, 0)
                gathered = array[safe]
                gathered[~vis] = 0.0
                padded[:n] = gathered
            return padded

        soft = sample.get("soft_masks")
        if soft is None or not len(soft):
            soft = np.zeros((0, h, w), np.float32)
        soft_masks.append(take(soft, (h, w)))
        gt_boxes_2d.append(take(sample.get("boxes_2d", np.zeros((0, 2, 2))), (2, 2)))
        vis_pad = np.zeros(n_pad, bool)
        vis_pad[:n] = vis
        visible.append(vis_pad)
        intrinsics.append(sample["intrinsic_matrix"])
        extrinsics.append(sample["extrinsic_matrix"])

    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    gt_boxes_3d = np.full((n_pad, 8, 3), np.nan, np.float32)
    gt_boxes_3d[:n] = target["boxes_3d"]

    return dict(
        soft_masks=soft_masks,
        intrinsics=np.stack(intrinsics),
        extrinsics=np.stack(extrinsics),
        gt_boxes_2d=np.stack(gt_boxes_2d),
        visible=np.stack(visible),
        valid=valid,
        gt_boxes_3d=gt_boxes_3d,
        rectification=target.get("rectification_matrix", np.eye(3, dtype=np.float32)),
        target_index=relative_indices.index(0),
    )


class KITTIRawDataset(KITTI360Dataset):
    """KITTI-Raw variant: the same contract with another annotation path;
    its boxes_3d are all NaN (no ground truth)."""

    @staticmethod
    def get_annotation_filename(image_filename):
        return image_filename.replace("image", "annotations").replace(".png", ".json")
