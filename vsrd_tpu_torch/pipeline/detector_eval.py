"""Detection quality of the trained detector: AP and KITTI AP|R40.

Counterpart of ``vsrd_tpu/pipeline/detector_eval.py``: AP at 3D-IoU
thresholds (continuous and the KITTI benchmark's 40-recall-point form, in
the devkit's easy, moderate and hard regimes when the batches carry the 2D
metadata), the mean matched 3D IoU and the matched corner L1, from the
detector's outputs against (pseudo-)ground-truth corner boxes. The
accumulation is host numpy, copied from the JAX package; the pairwise 3D
IoU runs on the port's ``ops/iou3d.py``, on CPU tensors: the evaluation
runs at checkpoint cadence, far off the training step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import geometry, iou3d


def _pairwise_iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """``[Qa, 8, 3] x [Qb, 8, 3]`` camera-frame corner boxes -> ``[Qa, Qb]``
    3D IoU, after the Rx(-pi/2) into the z-up frame ``box_3d_iou`` takes."""
    rot = geometry.rotation_matrix_x(torch.tensor(-math.pi / 2.0)).to(boxes_a.device)
    boxes_a = boxes_a @ rot.T
    boxes_b = boxes_b @ rot.T
    qa, qb = len(boxes_a), len(boxes_b)
    pairs_a = boxes_a[:, None].expand(qa, qb, 8, 3).reshape(-1, 8, 3)
    pairs_b = boxes_b[None].expand(qa, qb, 8, 3).reshape(-1, 8, 3)
    return iou3d.box_3d_iou(pairs_a, pairs_b)[0].reshape(qa, qb)


def extract_detections(outputs, score_threshold=0.0):
    """Detector outputs -> per image ``(boxes_3d, scores, labels)``: the
    score is the largest class probability of the (C+1)-way softmax with
    the no-object class dropped. Numpy, one entry per image."""
    probs = torch.softmax(torch.as_tensor(outputs["logits"]).float(), dim=-1)[..., :-1]
    probs = probs.detach().cpu().numpy()
    scores = probs.max(axis=-1)
    labels = probs.argmax(axis=-1)
    boxes = torch.as_tensor(outputs["boxes_3d"]).detach().cpu().numpy()
    dets = []
    for b in range(scores.shape[0]):
        keep = scores[b] >= score_threshold
        dets.append((boxes[b][keep], scores[b][keep], labels[b][keep]))
    return dets


def _precision_recall(scores, tp, num_gt):
    """Sorted-by-score precision envelope + recall curve."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    tp = np.asarray(tp, np.float64)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    return precision, recall


def average_precision(scores, tp, num_gt):
    """Continuous-interpolation AP (area under the precision envelope),
    the standard COCO-style estimator."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    precision, recall = _precision_recall(scores, tp, num_gt)
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[precision[0] if len(precision) else 0.0], precision])
    return float(np.sum((recall[1:] - recall[:-1]) * precision[1:]))


def average_precision_r40(scores, tp, num_gt):
    """KITTI AP|R40: mean precision over the 40 recall points {1/40, ...,
    40/40}; the precision at recall r is the envelope at the first
    operating point whose recall reaches r (0 if none does)."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    precision, recall = _precision_recall(scores, tp, num_gt)
    samples = np.arange(1, 41, dtype=np.float64) / 40.0
    idx = np.searchsorted(recall, samples - 1e-12, side="left")
    valid = idx < len(precision)
    sampled = np.where(valid, precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(sampled.mean())


# KITTI devkit difficulty regimes (devkit_object eval.cpp: MIN_HEIGHT,
# MAX_OCCLUSION, MAX_TRUNCATION). Heights are 2D box heights in pixels at
# the ORIGINAL image resolution; occlusion in {0,1,2}; truncation in [0,1].
# GT outside a regime is IGNORED for it (neither TP nor FN, and detections
# matched to it are dropped rather than counted FP), and detections shorter
# than MIN_HEIGHT are ignored likewise.
KITTI_DIFFICULTIES = {
    "easy": {"min_height": 40.0, "max_occlusion": 0, "max_truncation": 0.15},
    "moderate": {"min_height": 25.0, "max_occlusion": 1, "max_truncation": 0.30},
    "hard": {"min_height": 25.0, "max_occlusion": 2, "max_truncation": 0.50},
}


class DetectionEvaluator:
    """Accumulates per-image detections and GT; reports AP@{thresholds},
    AP|R40, the mean matched 3D IoU and the matched corner L1 (metres).
    Matching is greedy in confidence order per image and class, each GT
    box taken at most once."""

    def __init__(self, iou_thresholds=(0.25, 0.5), num_classes=1):
        self.iou_thresholds = tuple(iou_thresholds)
        self.num_classes = num_classes
        self.regimes = ("all",) + tuple(KITTI_DIFFICULTIES)
        self._records = {(c, t, r): [] for c in range(num_classes)
                         for t in self.iou_thresholds for r in self.regimes}
        self._num_gt = {(c, r): 0 for c in range(num_classes) for r in self.regimes}
        self._matched_ious = []
        self._matched_l1 = []
        self._has_difficulty = False

    def add_image(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                  gt_heights_px=None, gt_truncations=None, gt_occlusions=None,
                  det_heights_px=None):
        """det_boxes [Q,8,3], det_scores [Q], det_labels [Q]; gt_boxes
        [N,8,3], gt_labels [N] (valid rows only). The optional 2D metadata
        (pixel heights at the original resolution, truncation, occlusion)
        switches on the easy/moderate/hard regimes with the devkit's ignore
        rules; without it only "all" accumulates."""
        det_boxes = np.asarray(det_boxes, np.float32)
        gt_boxes = np.asarray(gt_boxes, np.float32)
        n_gt = len(gt_boxes)
        if gt_heights_px is not None:
            self._has_difficulty = True
            gt_heights_px = np.asarray(gt_heights_px, np.float32)
        gt_truncations = (np.zeros(n_gt, np.float32) if gt_truncations is None
                          else np.asarray(gt_truncations, np.float32))
        gt_occlusions = (np.zeros(n_gt, np.int32) if gt_occlusions is None
                         else np.asarray(gt_occlusions, np.int32))
        for c in range(self.num_classes):
            d_idx = np.nonzero(np.asarray(det_labels) == c)[0]
            g_idx = np.nonzero(np.asarray(gt_labels) == c)[0]
            order = d_idx[np.argsort(-np.asarray(det_scores)[d_idx], kind="stable")]
            iou = np.zeros((len(order), len(g_idx)), np.float32)
            if len(order) and len(g_idx):
                iou = _pairwise_iou_3d(torch.from_numpy(det_boxes[order]),
                                       torch.from_numpy(gt_boxes[g_idx])).numpy()
            scores = np.asarray(det_scores)[order]

            for regime in self.regimes:
                if regime == "all":
                    care = np.ones(len(g_idx), bool)
                    ignored_gt = np.zeros(len(g_idx), bool)
                    ignored_det = np.zeros(len(order), bool)
                elif not self._has_difficulty:
                    continue
                else:
                    spec = KITTI_DIFFICULTIES[regime]
                    h = gt_heights_px[g_idx]
                    care = ((h >= spec["min_height"])
                            & (gt_occlusions[g_idx] <= spec["max_occlusion"])
                            & (gt_truncations[g_idx] <= spec["max_truncation"]))
                    ignored_gt = ~care
                    ignored_det = (np.zeros(len(order), bool) if det_heights_px is None
                                   else np.asarray(det_heights_px, np.float32)[order]
                                   < spec["min_height"])
                self._num_gt[(c, regime)] += int(care.sum())
                for t in self.iou_thresholds:
                    taken = np.zeros(len(g_idx), bool)
                    for di in range(len(order)):
                        # best care-GT first (confidence-ordered greedy)
                        cand = np.where(taken | ~care, -1.0, iou[di])
                        gi = int(np.argmax(cand)) if len(g_idx) else 0
                        if len(g_idx) and cand[gi] >= t:
                            taken[gi] = True
                            if not ignored_det[di]:
                                self._records[(c, t, regime)].append((float(scores[di]), 1.0))
                            continue  # ignored det on care GT: absorbed
                        # overlaps an ignored GT: the det is absorbed
                        # (devkit "don't care" handling), not an FP
                        if len(g_idx) and np.any(ignored_gt & (iou[di] >= t)):
                            continue
                        if not ignored_det[di]:
                            self._records[(c, t, regime)].append((float(scores[di]), 0.0))
            # matched-quality stats at the loosest threshold ("all")
            if not len(order) or not len(g_idx):
                continue
            t0 = min(self.iou_thresholds)
            taken = np.zeros(len(g_idx), bool)
            for di, i in enumerate(order):
                gi = int(np.argmax(np.where(taken, -1.0, iou[di])))
                if not taken[gi] and iou[di, gi] >= t0:
                    taken[gi] = True
                    self._matched_ious.append(float(iou[di, gi]))
                    self._matched_l1.append(
                        float(np.abs(det_boxes[i] - gt_boxes[g_idx[gi]]).mean()))

    def _mean_ap(self, estimator, t, regime):
        aps = [
            estimator([s for s, _ in self._records[(c, t, regime)]],
                      [tp for _, tp in self._records[(c, t, regime)]],
                      self._num_gt[(c, regime)])
            for c in range(self.num_classes) if self._num_gt[(c, regime)] > 0
        ]
        return float(np.mean(aps)) if aps else float("nan")

    def summarize(self) -> dict:
        out = {}
        for t in self.iou_thresholds:
            out[f"ap_{t:g}"] = self._mean_ap(average_precision, t, "all")
            out[f"ap_r40_{t:g}"] = self._mean_ap(average_precision_r40, t, "all")
            if self._has_difficulty:
                for regime in KITTI_DIFFICULTIES:
                    out[f"ap_r40_{t:g}_{regime}"] = self._mean_ap(average_precision_r40, t,
                                                                  regime)
        out["mean_matched_iou_3d"] = (float(np.mean(self._matched_ious)) if self._matched_ious
                                      else 0.0)
        out["matched_corner_l1_m"] = (float(np.mean(self._matched_l1)) if self._matched_l1
                                      else float("nan"))
        num_gt_all = sum(self._num_gt[(c, "all")] for c in range(self.num_classes))
        out["num_gt"] = int(num_gt_all)
        out["recall_loosest"] = len(self._matched_ious) / max(num_gt_all, 1)
        return out


@torch.no_grad()
def evaluate_model(model, batches, num_classes=1, iou_thresholds=(0.25, 0.5),
                   score_threshold=0.05):
    """Run ``model`` (in eval mode, without gradients) over ``batches`` (the
    training step's dicts of tensors on the model's device) and return the
    summary dict. Batches with ``gt_heights_px [B, N]`` and ``orig_sizes
    [B, 2]`` (src_h, src_w) also fill the KITTI regimes; a detection's
    height is its normalized cxcywh height times src_h."""
    was_training = model.training
    model.eval()
    ev = DetectionEvaluator(iou_thresholds, num_classes)
    try:
        for batch in batches:
            outputs = model(batch["images"], batch["intrinsics"])
            outputs = {k: outputs[k].cpu() for k in ("logits", "boxes_3d", "boxes_2d")}
            probs = torch.softmax(outputs["logits"], dim=-1)[..., :-1].numpy()
            det_keep = probs.max(axis=-1) >= score_threshold
            dets = extract_detections(outputs, score_threshold)
            det_h_norm = outputs["boxes_2d"].numpy()[..., 3]
            valid = batch["valid"].cpu().numpy()
            gt3 = batch["boxes_3d"].cpu().numpy()
            gtl = batch["labels"].cpu().numpy()
            gt_h = batch.get("gt_heights_px")
            sizes = batch.get("orig_sizes")
            for b, (boxes, scores, labels) in enumerate(dets):
                keep = valid[b]
                kwargs = {}
                if gt_h is not None and sizes is not None:
                    kwargs["gt_heights_px"] = gt_h[b].cpu().numpy()[keep]
                    kwargs["det_heights_px"] = (det_h_norm[b][det_keep[b]]
                                                * float(sizes[b][0]))
                ev.add_image(boxes, scores, labels, gt3[b][keep], gtl[b][keep], **kwargs)
    finally:
        model.train(was_training)
    return ev.summarize()
