"""The port's detector evaluation (``vsrd_tpu_torch/pipeline/detector_eval.py``)
against ``vsrd_tpu/pipeline/detector_eval.py`` on the same numpy inputs:
AP, AP|R40, the evaluator's KITTI difficulty regimes and ``evaluate_model``
on the same detector outputs. The accumulation is numpy in both, so the AP
keys are held equal exactly; the matched 3D IoU and corner L1 come through
each package's own f32 box IoU and are held to 1e-6."""

import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import detector_eval as jeval
from vsrd_tpu_torch.pipeline import detector_eval as teval

MEAN_TOL = 1e-6


def _box(center, half=(0.9, 0.8, 2.2), yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    unit = np.asarray([[-1, -1, 1], [1, -1, 1], [1, -1, -1], [-1, -1, -1],
                       [-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]], np.float64)
    return ((unit * half) @ rot.T + center).astype(np.float32)


def _scene(rng, n_gt, n_det, num_classes=2):
    gt = np.stack([_box(rng.uniform([-10, 0, 8], [10, 1, 40]), yaw=rng.uniform(-1, 1))
                   for _ in range(n_gt)]) if n_gt else np.zeros((0, 8, 3), np.float32)
    gt_labels = rng.integers(0, num_classes, n_gt)
    # detections: jittered copies of some GT, plus strays
    dets, labels = [], []
    for i in range(n_det):
        if n_gt and rng.random() < 0.7:
            j = rng.integers(n_gt)
            dets.append(gt[j] + rng.normal(scale=0.3, size=(1, 3)).astype(np.float32))
            labels.append(gt_labels[j] if rng.random() < 0.9 else 1 - gt_labels[j])
        else:
            dets.append(_box(rng.uniform([-10, 0, 8], [10, 1, 40])))
            labels.append(rng.integers(0, num_classes))
    dets = np.stack(dets) if dets else np.zeros((0, 8, 3), np.float32)
    return dets, rng.random(n_det).astype(np.float32), np.asarray(labels, np.int64), gt, gt_labels


def _assert_summaries_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key in ("mean_matched_iou_3d", "matched_corner_l1_m"):
            assert got[key] == pytest.approx(value, abs=MEAN_TOL, nan_ok=True), key
        else:
            assert (got[key] == value) or (np.isnan(got[key]) and np.isnan(value)), key


@pytest.mark.parametrize("seed", range(4))
def test_average_precision_and_r40_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 30))
    scores = np.round(rng.random(n), 2)          # ties included
    tp = (rng.random(n) < 0.6).astype(np.float64)
    num_gt = int(tp.sum() + rng.integers(0, 4))
    for estimator in ("average_precision", "average_precision_r40"):
        got = getattr(teval, estimator)(scores, tp, num_gt)
        want = getattr(jeval, estimator)(scores, tp, num_gt)
        assert got == want or (np.isnan(got) and np.isnan(want)), estimator


@pytest.mark.parametrize("regimes", [False, True], ids=["all", "kitti_regimes"])
def test_evaluator_summaries_equal_jax(regimes):
    rng = np.random.default_rng(7)
    ours = teval.DetectionEvaluator((0.25, 0.5), num_classes=2)
    theirs = jeval.DetectionEvaluator((0.25, 0.5), num_classes=2)
    for image in range(6):
        dets, scores, labels, gt, gt_labels = _scene(rng, int(rng.integers(0, 6)),
                                                     int(rng.integers(0, 9)))
        kwargs = {}
        if regimes:
            kwargs = dict(gt_heights_px=rng.uniform(10, 80, len(gt)).astype(np.float32),
                          gt_truncations=rng.uniform(0, 0.6, len(gt)).astype(np.float32),
                          gt_occlusions=rng.integers(0, 3, len(gt)),
                          det_heights_px=rng.uniform(10, 80, len(dets)).astype(np.float32))
        ours.add_image(dets, scores, labels, gt, gt_labels, **kwargs)
        theirs.add_image(dets, scores, labels, gt, gt_labels, **kwargs)
    got, want = ours.summarize(), theirs.summarize()
    assert ("ap_r40_0.5_moderate" in want) == regimes
    _assert_summaries_equal(got, want)


def test_pairwise_iou_3d_matches_jax():
    rng = np.random.default_rng(3)
    dets, _, _, gt, _ = _scene(rng, 5, 7)
    got = teval._pairwise_iou_3d(torch.from_numpy(dets), torch.from_numpy(gt)).numpy()
    want = np.asarray(jeval._pairwise_iou_3d(dets, gt))
    assert np.abs(got - want).max() <= MEAN_TOL


class _FixedJaxModel:
    """Returns batch i's outputs for images filled with i (under jit)."""

    def __init__(self, outputs):
        self.stacked = {k: np.stack([o[k] for o in outputs]) for k in outputs[0]}

    def apply(self, params, images, intrinsics):
        import jax.numpy as jnp

        index = images[0, 0, 0, 0].astype(jnp.int32)
        return {k: jnp.asarray(v)[index] for k, v in self.stacked.items()}


class _FixedTorchModel(torch.nn.Module):
    def __init__(self, outputs):
        super().__init__()
        self.outputs = outputs

    def forward(self, images, intrinsics):
        return {k: torch.from_numpy(v) for k, v in self.outputs[int(images[0, 0, 0, 0])].items()}


def test_evaluate_model_on_the_same_outputs_equals_jax():
    """Both ``evaluate_model``s over two batches of one model's outputs (a
    stand-in model returns them), with the KITTI metadata."""
    rng = np.random.default_rng(11)
    b, q, n = 3, 6, 4
    outputs, batches = [], []
    for index in range(2):
        boxes = np.stack([np.stack([_box(rng.uniform([-8, 0, 8], [8, 1, 30]))
                                    for _ in range(q)]) for _ in range(b)])
        outputs.append({
            "logits": rng.normal(size=(b, q, 2)).astype(np.float32) * 2.0,
            "boxes_3d": boxes,
            "boxes_2d": rng.uniform(0.05, 0.4, size=(b, q, 4)).astype(np.float32),
        })
        gt = boxes[:, :n] + rng.normal(scale=0.2, size=(b, n, 1, 3)).astype(np.float32)
        images = np.full((b, 4, 4, 3), index, np.float32)
        batches.append(dict(
            images=images, intrinsics=np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)),
            labels=np.zeros((b, n), np.int32), boxes_3d=gt.astype(np.float32),
            valid=rng.random((b, n)) < 0.8,
            gt_heights_px=rng.uniform(10, 90, size=(b, n)).astype(np.float32),
            orig_sizes=np.asarray([[376.0, 1408.0]] * b, np.float32)))
    want = jeval.evaluate_model(_FixedJaxModel(outputs), None, batches)
    got = teval.evaluate_model(_FixedTorchModel(outputs),
                               [{k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in batch.items()} for batch in batches])
    assert "ap_r40_0.25_hard" in want
    _assert_summaries_equal(got, want)
