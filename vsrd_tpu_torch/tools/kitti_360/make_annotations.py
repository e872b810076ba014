"""KITTI-360 raw data -> per-frame annotation JSONs.

Counterpart of ``tools/kitti_360/make_annotations.py``, with its CLI and
files (``python -m vsrd_tpu_torch.tools.kitti_360.make_annotations``): reads
the ``P_rect_01`` intrinsic and stereo baseline of
``calibration/perspective.txt``, the ``data_poses/<seq>/cam0_to_world.txt``
poses (inverted to world -> camera), the 3D boxes of
``data_3d_bboxes/train/<seq>.xml`` (converted to the KITTI-360
"evaluation" corner order; ``timestamp -1`` marks a static box) and the
16-bit instance PNGs (``data/png.py::read_png_anydepth``, what
``cv2.imread(..., IMREAD_ANYDEPTH)`` gives), and writes per instance a COCO
RLE mask and camera-space corners:

    {"intrinsic_matrix": 3x3, "extrinsic_matrix": 4x4,
     "masks": {class: {instance_id: RLE}},
     "boxes_3d": {class: {instance_id: 8x3}}}

to ``annotations/<seq>/.../<frame>.json``, the JAX tool's files byte for
byte.
"""

import argparse
import collections
import functools
import glob
import json
import multiprocessing
import os
import xml.etree.ElementTree

import numpy as np

from ...data import png, rle

# KITTI-360 semantic label table (subset; cityscapes-compatible ids).
# kittiId is the id used inside the 3D bbox XML; id*1000+instance is the
# instance-map encoding. Override with --label_map for other classes.
DEFAULT_LABELS = {
    # name: (id, kittiId)
    "building": (11, 11),
    "person": (24, 19),
    "rider": (25, 20),
    "car": (26, 13),
    "truck": (27, 14),
    "bus": (28, 34),
    "caravan": (29, 16),
    "trailer": (30, 15),
    "train": (31, 33),
    "motorcycle": (32, 17),
    "bicycle": (33, 18),
}

# corner reorder: KITTI-360 "annotation" -> "evaluation" format
EVAL_CORNER_ORDER = [0, 2, 7, 5, 1, 3, 6, 4]


def load_labels(label_map_path=None):
    labels = dict(DEFAULT_LABELS)
    if label_map_path:
        with open(label_map_path) as file:
            labels.update({k: tuple(v) for k, v in json.load(file).items()})
    id_to_name = {v[0]: k for k, v in labels.items()}
    kitti_to_id = {v[1]: v[0] for k, v in labels.items()}
    return id_to_name, kitti_to_id


def read_calibration(root_dirname):
    """The ``P_rect_01`` intrinsic and the 4x4 translation by its baseline
    (the JAX tool's, which shifts ``image_01`` frames by it)."""
    translation_matrix = np.eye(4)
    with open(os.path.join(root_dirname, "calibration", "perspective.txt")) as file:
        for line in file:
            name, *values = line.split()
            if name == "P_rect_01:":
                projection = np.array(list(map(float, values))).reshape(3, 4)
                intrinsic_matrix = projection[:, :3]
                translation_matrix[:3, 3] = projection[:, 3] / np.diag(intrinsic_matrix)
                return intrinsic_matrix, translation_matrix
    raise ValueError("P_rect_01 not found")


def read_extrinsics(root_dirname, sequence):
    """Frame index -> world->camera matrix, the inverse of each pose."""
    extrinsic_matrices = {}
    with open(os.path.join(root_dirname, "data_poses", sequence, "cam0_to_world.txt")) as file:
        for line in file:
            frame_index, *values = line.split()
            cam_to_world = np.array(list(map(float, values))).reshape(4, 4)
            extrinsic_matrices[int(frame_index)] = np.linalg.inv(cam_to_world)
    return extrinsic_matrices


def read_world_boxes(root_dirname, sequence, kitti_to_id):
    """Timestamp -> instance id -> world-frame 8 corners in evaluation
    order (homogeneous, [8, 4]); empty where the sequence has no XML."""
    box_filename = os.path.join(root_dirname, "data_3d_bboxes", "train", f"{sequence}.xml")
    world_boxes = collections.defaultdict(dict)
    if not os.path.exists(box_filename):
        return world_boxes
    for child in xml.etree.ElementTree.parse(box_filename).getroot():
        semantic_id = kitti_to_id.get(int(child.find("semanticId").text))
        if semantic_id is None:
            continue
        instance_id = semantic_id * 1000 + int(child.find("instanceId").text)
        transform = np.array(
            list(map(float, child.find("transform").find("data").text.split()))).reshape(4, 4)
        vertices = np.array(
            list(map(float, child.find("vertices").find("data").text.split()))).reshape(-1, 3)[:8]
        vertices = vertices[EVAL_CORNER_ORDER]
        vertices_h = np.pad(vertices, ((0, 0), (0, 1)), constant_values=1.0)
        world_boxes[int(child.find("timestamp").text)][instance_id] = vertices_h @ transform.T
    return world_boxes


def annotate_frame(instance_map, frame_index, intrinsic_matrix, extrinsic_matrix, world_boxes,
                   id_to_name):
    """One frame's annotation dict from its instance map, in the JAX tool's
    key order: a mask for every labelled id of the map (ascending), and its
    camera-space box where the XML has one for the frame or a static one."""
    masks, boxes_3d = collections.defaultdict(dict), collections.defaultdict(dict)
    for instance_id in np.unique(instance_map).tolist():
        class_name = id_to_name.get(instance_id // 1000)
        if class_name is None:
            continue
        mask = (instance_map == instance_id).astype(np.uint8)
        masks[class_name][str(instance_id)] = rle.encode(mask)
        boxes_3d.setdefault(class_name, {})
        box = world_boxes.get(frame_index, {}).get(
            instance_id, world_boxes.get(-1, {}).get(instance_id))
        if box is None:
            continue
        cam_box = box @ extrinsic_matrix.T
        cam_box = cam_box[:, :3] / cam_box[:, 3:]
        boxes_3d[class_name][str(instance_id)] = cam_box.tolist()
    return {
        "intrinsic_matrix": intrinsic_matrix.tolist(),
        "extrinsic_matrix": extrinsic_matrix.tolist(),
        "masks": {k: dict(v) for k, v in masks.items()},
        "boxes_3d": {k: dict(v) for k, v in boxes_3d.items()},
    }


def make_annotations(sequence, root_dirname, label_map=None):
    id_to_name, kitti_to_id = load_labels(label_map)
    intrinsic_matrix, translation_matrix = read_calibration(root_dirname)
    extrinsic_matrices = read_extrinsics(root_dirname, sequence)
    world_boxes = read_world_boxes(root_dirname, sequence, kitti_to_id)
    image_filenames = sorted(glob.glob(
        os.path.join(root_dirname, "data_2d_raw", sequence, "**", "*.png"), recursive=True))
    for image_filename in image_filenames:
        frame_index = int(os.path.splitext(os.path.basename(image_filename))[0])
        instance_filename = image_filename.replace(
            "data_2d_raw", "data_2d_semantics/train").replace("data_rect", "instance")
        if frame_index not in extrinsic_matrices or not os.path.exists(instance_filename):
            continue
        extrinsic_matrix = extrinsic_matrices[frame_index]
        if "image_01" in image_filename:
            extrinsic_matrix = translation_matrix @ extrinsic_matrix
        annotation = annotate_frame(png.read_png_anydepth(instance_filename), frame_index,
                                    intrinsic_matrix, extrinsic_matrix, world_boxes, id_to_name)
        annotation_filename = image_filename.replace(
            "data_2d_raw", "annotations").replace(".png", ".json")
        os.makedirs(os.path.dirname(annotation_filename), exist_ok=True)
        with open(annotation_filename, "w") as file:
            json.dump(annotation, file, indent=4)


def main(args):
    sequences = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(args.root_dirname, "data_2d_raw", "*"))
    )
    worker = functools.partial(
        make_annotations, root_dirname=args.root_dirname, label_map=args.label_map
    )
    if args.num_workers > 1:
        with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
            for index, _ in enumerate(pool.imap_unordered(worker, sequences)):
                print(f"[{index + 1}/{len(sequences)}] done")
    else:
        for index, sequence in enumerate(sequences):
            worker(sequence)
            print(f"[{index + 1}/{len(sequences)}] {sequence} done")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: Annotation Maker for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--num_workers", type=int, default=9)
    parser.add_argument("--label_map", type=str, default=None,
                        help="JSON {name: [id, kittiId]} overriding defaults")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
