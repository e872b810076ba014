"""Render pseudo-label prediction visualizations, colored by confidence.

Counterpart of ``tools/kitti_360/visualize_predictions.py``, with its CLI
and files (``python -m vsrd_tpu_torch.tools.kitti_360.visualize_predictions``):
each predicted wireframe drawn by ``visualization/drawers.py`` in the color
of its confidence on OpenCV's ``COLORMAP_JET`` (``JET_LUT``, the table
``cv2.applyColorMap`` reads); PNGs under ``<out_dirname>/<sequence>/`` and,
where cv2 is installed, the ``mp4v`` video (``visualize_annotations.
SequenceVideo``).
"""

import argparse
import glob
import json
import os

import numpy as np

from ...data import png
from ...visualization import drawers
from .visualize_annotations import SequenceVideo


def _jet_lut() -> np.ndarray:
    """OpenCV's COLORMAP_JET as RGB uint8 [256, 3]: each channel a ramp of 4
    levels per entry, clipped to [0, 255]; OpenCV's float table rounds blue
    at 159 down to 1."""
    i = np.arange(256)
    lut = np.clip(np.stack([np.minimum(4 * i - 382, 1148 - 4 * i),
                            np.minimum(4 * i - 128, 892 - 4 * i),
                            np.minimum(4 * i + 128, 638 - 4 * i)], axis=-1), 0, 255)
    lut[159, 2] = 1
    return lut.astype(np.uint8)


JET_LUT = _jet_lut()


def jet_color(value):
    """The RGB color of ``value`` in [0, 1] on the jet colormap, as ints."""
    value = float(np.clip(value, 0.0, 1.0))
    return tuple(int(c) for c in JET_LUT[int(value * 255)])


def visualize_sequence(sequence, root_dirname, ckpt_dirname, out_dirname, fps):
    """Writes the sequence's PNGs (and video); returns the PNGs' paths."""
    prediction_dirname = os.path.join("predictions", os.path.basename(ckpt_dirname))
    prediction_filenames = sorted(glob.glob(os.path.join(
        root_dirname, prediction_dirname, sequence, "image_00", "data_rect", "*.json")))
    video = SequenceVideo(os.path.join(out_dirname, f"{sequence}.mp4"), fps)
    written = []
    for prediction_filename in prediction_filenames:
        image_filename = prediction_filename.replace(
            prediction_dirname, "data_2d_raw").replace(".json", ".png")
        annotation_filename = prediction_filename.replace(prediction_dirname, "annotations")
        if not os.path.exists(image_filename):
            continue
        with open(prediction_filename) as file:
            prediction = json.load(file)
        with open(annotation_filename) as file:
            annotation = json.load(file)

        image = png.read_rgb(image_filename).astype(np.float32) / 255.0
        intrinsic = np.asarray(annotation["intrinsic_matrix"])
        for class_name, boxes in prediction["boxes_3d"].items():
            confidences = prediction["confidences"].get(class_name, [])
            for box, confidence in zip(boxes, confidences):
                image = drawers.draw_boxes_3d(image, np.asarray(box)[None], intrinsic,
                                              color=jet_color(confidence))

        frame = (np.clip(image, 0, 1) * 255).astype(np.uint8)
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
            sequence, args.root_dirname, args.ckpt_dirname, args.out_dirname, args.fps
        )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: Prediction Visualizer for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--ckpt_dirname", type=str, default="ckpts/kitti_360/vsrd")
    parser.add_argument("--out_dirname", type=str, default="visualizations/predictions")
    parser.add_argument("--fps", type=int, default=10)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
