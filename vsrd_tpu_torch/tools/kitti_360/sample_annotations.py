"""Target/source frame sampling for KITTI-360 auto-labeling.

Counterpart of ``tools/kitti_360/sample_annotations.py``, with its CLI and
files (``python -m vsrd_tpu_torch.tools.kitti_360.sample_annotations``): per
candidate target frame, scan forward/backward while >= R of the
target's (area/box-size-filtered) instance ids stay visible; group frames
by identical instance-id set and pick the median frame of each group as
the target. Writes ``grouped_image_filenames.txt`` and
``sampled_image_filenames.txt`` under
``filenames/R<ratio>-N<frames>-M<area>-B<size>/<sequence>/``.
"""

import argparse
import collections
import functools
import glob
import itertools
import json
import multiprocessing
import os

import numpy as np

from ...data import rle


def _valid_instance_ids(annotation, class_names, min_mask_area, min_box_size):
    ids = []
    for class_name, masks in annotation["masks"].items():
        if class_name not in class_names:
            continue
        for instance_id, mask_rle in masks.items():
            mask = rle.decode(mask_rle)
            area = int(mask.sum())
            if area < min_mask_area:
                continue
            ys, xs = np.nonzero(mask)
            if not len(ys):
                continue
            box_size = min(ys.max() - ys.min(), xs.max() - xs.min())
            if box_size < min_box_size:
                continue
            ids.append(instance_id)
    return ids


def sample_annotations(sequence, root_dirname, class_names, num_instance_ratio,
                       num_source_frames, min_mask_area, min_box_size):
    image_filenames = sorted(
        glob.glob(
            os.path.join(
                root_dirname, "data_2d_raw", sequence, "image_00", "data_rect", "*.png"
            )
        )
    )
    if not image_filenames:
        return
    frame_indices = [
        int(os.path.splitext(os.path.basename(f))[0]) for f in image_filenames
    ]
    min_frame, max_frame = min(frame_indices), max(frame_indices)

    annotation_cache = {}

    def read(annotation_filename):
        if annotation_filename not in annotation_cache:
            if not os.path.exists(annotation_filename):
                annotation_cache[annotation_filename] = None
            else:
                with open(annotation_filename) as file:
                    annotation = json.load(file)
                annotation_cache[annotation_filename] = _valid_instance_ids(
                    annotation, class_names, min_mask_area, min_box_size
                )
        return annotation_cache[annotation_filename]

    grouped = collections.defaultdict(list)

    for target_image_filename in image_filenames:
        target_annotation_filename = target_image_filename.replace(
            "data_2d_raw", "annotations"
        ).replace(".png", ".json")
        target_ids = read(target_annotation_filename)
        if not target_ids:
            continue
        target_frame = int(
            os.path.splitext(os.path.basename(target_annotation_filename))[0]
        )

        source_relative_indices = []
        for direction in (1, -1):
            for step in itertools.count(1):
                source_frame = target_frame + direction * step
                if source_frame > max_frame or source_frame < min_frame:
                    break
                filename = os.path.join(
                    os.path.dirname(target_annotation_filename),
                    f"{source_frame:010}.json",
                )
                if not os.path.exists(filename):
                    continue
                source_ids = read(filename) or []
                overlap = len(set(target_ids) & set(source_ids)) / len(target_ids)
                if overlap < num_instance_ratio:
                    break
                source_relative_indices.append(direction * step)

        if len(source_relative_indices) >= num_source_frames:
            grouped[tuple(sorted(target_ids))].append(
                (target_image_filename, sorted(source_relative_indices))
            )

    split = (
        f"R{num_instance_ratio * 100.0:.0f}-N{num_source_frames}-"
        f"M{min_mask_area}-B{min_box_size}"
    )
    out_dir = os.path.join(root_dirname, "filenames", split, sequence)
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "grouped_image_filenames.txt"), "w") as gf, \
         open(os.path.join(out_dir, "sampled_image_filenames.txt"), "w") as sf:
        for target_ids, group in grouped.items():
            group = sorted(
                group,
                key=lambda item: int(os.path.splitext(os.path.basename(item[0]))[0]),
            )
            target_image_filename, source_relative_indices = group[len(group) // 2]
            gf.write(
                f"{','.join(target_ids)} "
                f"{','.join(filename for filename, _ in group)}\n"
            )
            sf.write(
                f"{','.join(target_ids)} {target_image_filename} "
                f"{','.join(map(str, source_relative_indices))}\n"
            )


def main(args):
    sequences = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(args.root_dirname, "data_2d_raw", "*"))
    )
    worker = functools.partial(
        sample_annotations,
        root_dirname=args.root_dirname,
        class_names=args.class_names,
        num_instance_ratio=args.num_instance_ratio,
        num_source_frames=args.num_source_frames,
        min_mask_area=args.min_mask_area,
        min_box_size=args.min_box_size,
    )
    if args.num_workers > 1:
        with multiprocessing.Pool(args.num_workers) as pool:
            for index, _ in enumerate(pool.imap_unordered(worker, sequences)):
                print(f"[{index + 1}/{len(sequences)}] done")
    else:
        for sequence in sequences:
            worker(sequence)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="vsrd_tpu_torch: Annotation Sampler for KITTI-360"
    )
    parser.add_argument("--root_dirname", type=str, default="datasets/KITTI-360")
    parser.add_argument("--class_names", type=str, nargs="+", default=["car"])
    parser.add_argument("--num_instance_ratio", type=float, default=0.5)
    parser.add_argument("--num_source_frames", type=int, default=16)
    parser.add_argument("--min_mask_area", type=int, default=128)
    parser.add_argument("--min_box_size", type=int, default=16)
    parser.add_argument("--num_workers", type=int, default=9)
    main(parser.parse_args())
