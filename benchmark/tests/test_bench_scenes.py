"""The benchmark's scenes, made by torch, against the port's
``synthetic_frame`` (host numpy) on the same layout draws."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import scenes  # noqa: E402
from vsrd_tpu_torch.pipeline import frame as fm  # noqa: E402

FIELDS = ("soft_masks_flat", "sampling_weights", "gt_boxes_2d", "visible", "valid", "gt_boxes_3d",
          "intrinsics", "extrinsics", "inv_projections", "camera_positions")


@pytest.mark.parametrize("seed,instances,max_instances", [(0, 5, 6), (7, 4, 4),
                                                          (2**31 + 5, 3, 3)])
def test_boxes_and_masks_equal_synthetic_frame(seed, instances, max_instances):
    size = (40, 64)
    ref = fm.synthetic_frame(seed, num_views=3, image_size=size, num_instances=instances,
                             max_instances=max_instances, layout="kitti", device="cpu")
    mine = scenes.frame_scene(np.random.default_rng(seed), torch.Generator().manual_seed(1), 3,
                              size, instances, max_instances, 1 << 18, "cpu")
    for name in FIELDS:
        a, b = getattr(ref, name), mine[name]
        assert torch.equal(torch.nan_to_num(a.float()), torch.nan_to_num(b.float())), name
    assert ref.target_index == mine["target_index"]
    # every pixel is a candidate at this size; the order differs by tie-break
    assert torch.equal(ref.candidate_indices.sort().values, mine["candidate_indices"].sort().values)


def test_candidates_are_the_heaviest_pixels():
    rng = np.random.default_rng(3)
    scene = scenes.frame_scene(rng, torch.Generator().manual_seed(2), 2, (32, 48), 3, 4, 200, "cpu")
    weights = scene["sampling_weights"]
    chosen = scene["candidate_indices"]
    assert chosen.numel() == 200 and chosen.unique().numel() == 200
    assert weights[chosen].min() >= weights.sort(descending=True).values[199]
    assert torch.equal(scene["candidate_weights"], torch.log(weights[chosen]))


def test_same_seed_same_scene():
    cfg = {"views": 2, "image_size": [24, 32], "instances": 3, "max_instances": 3,
           "candidates": 64}
    a, b = (scenes.make_scenes(2**31 + 99, 2, cfg, "cpu") for _ in range(2))
    for sa, sb in zip(a, b):
        for name in ("soft_masks_flat", "candidate_indices", "gt_boxes_3d"):
            assert torch.equal(torch.nan_to_num(sa[name].float()), torch.nan_to_num(sb[name].float()))
    assert not torch.equal(a[0]["soft_masks_flat"], a[1]["soft_masks_flat"])
