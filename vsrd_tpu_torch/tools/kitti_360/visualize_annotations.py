"""Render per-sequence annotation visualizations (PNGs, and an mp4 where
OpenCV is installed).

Counterpart of ``tools/kitti_360/visualize_annotations.py``, with its CLI
and files (``python -m vsrd_tpu_torch.tools.kitti_360.visualize_annotations``):
the masks of ``--class_names`` alpha-blended and their 3D wireframes (with
two face diagonals) drawn by ``visualization/drawers.py``, which gives
OpenCV's pixels, on the frames read by ``data/png.py``; one PNG per frame
under ``<out_dirname>/<sequence>/``. The ``mp4v`` video
``<out_dirname>/<sequence>.mp4`` needs ``cv2.VideoWriter``: without cv2
the PNGs are written and one line says that no video was.
"""

import argparse
import glob
import json
import os

import numpy as np

from ...data import png, rle
from ...visualization import drawers

try:
    import cv2   # only for cv2.VideoWriter; no video encoder is installed without it
except ImportError:
    cv2 = None


class SequenceVideo:
    """The ``mp4v`` video of one sequence's frames, opened at the first
    frame, as the JAX tools write it; without cv2, ``close`` prints why no
    video was written."""

    def __init__(self, filename: str, fps: int):
        self.filename, self.fps = filename, fps
        self.writer, self.frames = None, 0

    def write(self, frame: np.ndarray) -> None:
        """Append an RGB uint8 frame."""
        self.frames += 1
        if cv2 is None:
            return
        if self.writer is None:
            h, w = frame.shape[:2]
            self.writer = cv2.VideoWriter(self.filename, cv2.VideoWriter_fourcc(*"mp4v"),
                                          self.fps, (w, h))
        self.writer.write(np.ascontiguousarray(frame[..., ::-1]))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
        elif self.frames and cv2 is None:
            print(f"no video written to {self.filename}: cv2 is not installed, and the mp4v "
                  f"encoder is cv2.VideoWriter's; the {self.frames} PNGs are written", flush=True)


def visualize_frame(image_filename, annotation, class_names):
    """One frame's masks and wireframes over its image: RGB uint8."""
    image = png.read_rgb(image_filename).astype(np.float32) / 255.0
    masks, boxes_3d = [], []
    for class_name, class_masks in annotation["masks"].items():
        if class_name not in class_names:
            continue
        class_boxes = annotation.get("boxes_3d", {}).get(class_name, {})
        for instance_id, mask_rle in class_masks.items():
            masks.append(rle.decode(mask_rle).astype(np.float32))
            if instance_id in class_boxes:
                boxes_3d.append(np.asarray(class_boxes[instance_id]))
    if masks:
        image = drawers.draw_masks(image, np.stack(masks))
    if boxes_3d:
        image = drawers.draw_boxes_3d(image, np.stack(boxes_3d),
                                      np.asarray(annotation["intrinsic_matrix"]),
                                      line_indices=drawers.LINE_INDICES + [[0, 5], [1, 4]])
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def visualize_sequence(sequence, root_dirname, out_dirname, class_names, fps):
    """Writes the sequence's PNGs (and video); returns the PNGs' paths."""
    image_filenames = sorted(glob.glob(os.path.join(
        root_dirname, "data_2d_raw", sequence, "image_00", "data_rect", "*.png")))
    video = SequenceVideo(os.path.join(out_dirname, f"{sequence}.mp4"), fps)
    written = []
    for image_filename in image_filenames:
        annotation_filename = image_filename.replace(
            "data_2d_raw", "annotations").replace(".png", ".json")
        if not os.path.exists(annotation_filename):
            continue
        with open(annotation_filename) as file:
            annotation = json.load(file)
        frame = visualize_frame(image_filename, annotation, class_names)
        out_png = os.path.join(out_dirname, sequence, os.path.basename(image_filename))
        os.makedirs(os.path.dirname(out_png), exist_ok=True)
        png.write_png(out_png, frame)
        written.append(out_png)
        video.write(frame)
    video.close()
    return written


def main(args):
    sequences = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(args.root_dirname, "data_2d_raw", "*"))
    )
    for sequence in sequences:
        visualize_sequence(
            sequence, args.root_dirname, args.out_dirname, args.class_names, args.fps
        )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: Annotation Visualizer for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--out_dirname", type=str, default="visualizations/annotations")
    parser.add_argument("--class_names", type=str, nargs="+", default=["car"])
    parser.add_argument("--fps", type=int, default=10)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
