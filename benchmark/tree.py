"""A KITTI-360-layout tree of target frames and their source frames, written
from a seed by the benchmark itself for the labeling driver to read.

The scenes are ``scenes.py``'s: each target is a rig of ``views`` cameras
along +z with the target in the middle and the cars of ``scenes.make_scenes``;
a car's mask in a view is its slab-test hit mask. The data path's work
follows the cars' sizes in the images, so every seed gets the same scenes,
those that ``make_scenes`` draws from the traffic's ``layout_seed``, and the
seed draws their order among the targets, each target's order of cars (its
instance ids) and the rigs' poses in the world. The tree holds what the
driver reads with the photometric branch off:

* ``data_2d_raw/<drive>/image_00/data_rect/<frame>.png``: the PNG signature
  and its header chunks alone, no pixels (the driver reads an image's size
  from its header and decodes pixels only for the photometric branch);
* ``annotations/<drive>/image_00/data_rect/<frame>.json``: K, the camera's
  world-to-camera matrix, and for every car with at least
  ``scenes.MIN_VISIBLE_PIXELS`` hit pixels its mask in COCO RLE (column-major
  runs, pycocotools' compressed string) and its box's corners in that
  camera's coordinates;
* ``filenames/bench/<drive>/sampled_image_filenames.txt``: one line per
  target, its source frames by relative index;
* ``configs/bench/<drive>/config.json``: the driver's configuration.

Each target's rig stands in the world at a pose drawn from the seed (a yaw, a
pitch of up to ``PITCH`` rad, a position along a drive), so that the
world-to-camera matrices and the driver's gravity rectification are not the
identity. Targets share no frame. Nothing here imports the port.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np
import torch

from benchmark import scenes

DRIVE = "2013_05_28_drive_0000_sync"
CAR_ID = 26000                  # KITTI-360's car label x 1000: ids 26000, 26001, ...
FIRST_FRAME = 100
PITCH = 0.03
# a level camera's axes (x right, y down, z forward) in world axes (x forward, y left, z up)
CAMERA_TO_WORLD = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def png_header(height: int, width: int) -> bytes:
    """A PNG's signature, IHDR (8-bit RGB) and IEND chunks, without pixels."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                                             0, 0, 0)) + chunk(b"IEND", b""))


def rle_counts(masks: torch.Tensor) -> list[np.ndarray]:
    """COCO's uncompressed counts of masks ``[n, H, W]`` (bool): the lengths of
    alternating runs of 0 and 1 in column-major order, starting with 0s. The
    run edges are found on the masks' device."""
    n, h, w = masks.shape
    flat = masks.transpose(1, 2).reshape(n, h * w)
    row, col = torch.nonzero(flat[:, 1:] != flat[:, :-1], as_tuple=True)
    first = flat[:, 0].cpu().numpy()
    row, col = row.cpu().numpy(), col.cpu().numpy() + 1
    bounds = np.searchsorted(row, np.arange(n + 1))
    out = []
    for i in range(n):
        edges = np.concatenate([[0], col[bounds[i]:bounds[i + 1]], [h * w]])
        runs = np.diff(edges)
        out.append(np.concatenate([[0], runs]) if first[i] else runs)
    return out


def compress_counts(counts: np.ndarray) -> str:
    """pycocotools' ``rleToString``: each count from the fourth on less the
    count two before it, then in 5-bit groups, low first, each with a
    continuation bit (0x20) and 48 added; a group ends the number when the
    rest is its sign extension."""
    counts = np.asarray(counts, np.int64)
    x = counts.copy()
    x[3:] -= counts[1:-2]
    groups = np.zeros((len(x), 13), np.uint8)
    lengths = np.zeros(len(x), np.int64)
    more = np.ones(len(x), bool)
    k = 0
    while more.any():
        c = x & 0x1F
        x = x >> 5
        going = np.where(c & 0x10, x != -1, x != 0) & more
        groups[:, k] = np.where(more, c + 0x20 * going + 48, 0)
        lengths += more
        more = going
        k += 1
    keep = np.arange(k)[None, :] < lengths[:, None]
    return groups[:, :k][keep].tobytes().decode("ascii")


def rotation_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rotation_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rig_pose(seed: int, target: int) -> np.ndarray:
    """The world pose ``[4, 4]`` (rig -> world, float64) of a target's rig."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0xD21E, target]))
    yaw, pitch = rng.uniform(-math.pi, math.pi), rng.uniform(-PITCH, PITCH)
    pose = np.eye(4)
    pose[:3, :3] = rotation_z(yaw) @ CAMERA_TO_WORLD @ rotation_x(pitch)
    pose[:3, 3] = [100.0 + 40.0 * target, 300.0 + 10.0 * target, 5.0] + rng.uniform(-5, 5, 3)
    return pose


def relative_indices(views: int, target_index: int) -> list[int]:
    return [v - target_index for v in range(views) if v != target_index]


def write(root: str, seed: int, config: dict, traffic: dict, device) -> dict:
    """Write the tree of ``traffic["targets"]`` targets under ``root``.
    Returns the driver's config path, the image paths and, per target, what
    was written: ``intrinsics`` and world-to-camera ``extrinsics`` [V, ...]
    (float64), the cars' hit ``masks`` [V, n, H, W] (bool, on the host), which
    of them were written (``written`` [V, n]), their ``boxes_2d`` [V, n, 2, 2]
    (the hit pixels' extent) and the target camera's ``boxes_3d`` [n, 8, 3]."""
    h, w = config["image_size"]
    views, instances = config["views"], config["instances"]
    made = scenes.make_scenes(traffic["layout_seed"], traffic["targets"], config, device)
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0x0DE2]))
    made = [made[i] for i in rng.permutation(len(made))]
    t_index = made[0]["target_index"]
    image_dir = os.path.join(root, "data_2d_raw", DRIVE, "image_00", "data_rect")
    label_dir = os.path.join(root, "annotations", DRIVE, "image_00", "data_rect")
    os.makedirs(image_dir)
    os.makedirs(label_dir)
    header = png_header(h, w)
    truth, lines, images = [], [], []
    for t, scene in enumerate(made):
        pose = rig_pose(seed, t)
        hits = (scene["soft_masks_flat"][:, :instances] > 0.5).reshape(views, h, w, instances)
        cars = torch.as_tensor(rng.permutation(instances), device=hits.device)
        hits = hits.permute(0, 3, 1, 2)[:, cars].contiguous()              # [V, n, H, W]
        written = scene["visible"][:, cars].cpu().numpy()
        intrinsics = scene["intrinsics"].double().cpu().numpy()
        rig = scene["extrinsics"].double().cpu().numpy()                   # rig -> camera
        extrinsics = rig @ np.linalg.inv(pose)                             # world -> camera
        corners = scene["gt_boxes_3d"][cars].double().cpu().numpy()       # in the rig
        for v in range(views):
            frame = FIRST_FRAME + t * views + v
            with open(os.path.join(image_dir, f"{frame:010d}.png"), "wb") as file:
                file.write(header)
            counts = rle_counts(hits[v])
            cam = corners @ rig[v, :3, :3].T + rig[v, :3, 3]
            masks, boxes = {}, {}
            for i in np.flatnonzero(written[v]):
                masks[str(CAR_ID + i)] = {"size": [h, w], "counts": compress_counts(counts[i])}
                boxes[str(CAR_ID + i)] = cam[i].tolist()
            annotation = {"intrinsic_matrix": intrinsics[v].tolist(),
                          "extrinsic_matrix": extrinsics[v].tolist(),
                          "masks": {"car": masks}, "boxes_3d": {"car": boxes}}
            with open(os.path.join(label_dir, f"{frame:010d}.json"), "w") as file:
                json.dump(annotation, file)
        image = os.path.join(image_dir, f"{FIRST_FRAME + t * views + t_index:010d}.png")
        ids = ",".join(str(CAR_ID + i) for i in range(instances))
        rels = ",".join(map(str, relative_indices(views, t_index)))
        lines.append(f"{ids} {image} {rels}\n")
        images.append(image)
        truth.append({"intrinsics": intrinsics, "extrinsics": extrinsics,
                      "masks": hits.cpu(), "written": written,
                      "boxes_2d": scene["gt_boxes_2d"][:, cars].cpu().numpy(),
                      "boxes_3d": corners, "target_index": t_index})
    del made
    split = os.path.join(root, "filenames", "bench", DRIVE)
    os.makedirs(split)
    sampled = os.path.join(split, "sampled_image_filenames.txt")
    with open(sampled, "w") as file:
        file.writelines(lines)
    driver = json.loads(json.dumps(config["driver"]))
    driver["datasets"]["train"]["kwargs"]["filenames"] = [sampled]
    driver["optimization"]["frames_per_batch"] = traffic["frames_per_batch"]
    config_path = os.path.join(root, "configs", "bench", DRIVE, "config.json")
    os.makedirs(os.path.dirname(config_path))
    with open(config_path, "w") as file:
        json.dump(driver, file, indent=1)
    return {"config": config_path, "images": images, "truth": truth}
