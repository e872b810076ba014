"""The plain reference of the labeling driver's data path, and the numbers
that hold each target frame's ``FrameData``, as the driver built it, against
what the tree writer (``tree.py``) wrote.

What a frame should hold, from the published rules (numpy and torch, no
import of the port):

* the target's instances: the cars written in the target view that pass the
  target chain's filters (mask area at least ``target_min_mask_area`` pixels,
  the 2D box's shorter side at least ``target_min_box_size``), in the order
  written; padded to the first instance bucket (8, 16, 24, 32) that holds
  them;
* the views in the order of their relative index, the target's among them;
* in each view, an instance is visible where its car was written there and
  passes that view's filters (the source chain's ``min_mask_area`` and
  ``min_box_size``; the target's in the target view); its 2D box is its
  mask's extent ``[[x0, y0], [x1, y1]]``, zeros where it is not visible;
* K as written (the resize is to the written size), and each view's
  extrinsic matrix rectified to the target, ``E_v E_t^-1 [[Q^T, 0], [0,
  1]]`` in float64, with ``Q`` the rotation about the target camera's x axis
  that takes gravity onto the camera's y axis (gravity: the world axis
  nearest to the camera's y axis, seen from the camera);
* the target's 3D boxes as written (float32), NaN in padded slots;
* its soft masks at 0.5 equal to the written masks (the chain re-fills a
  mask from its outer contour and softens it by the distance to that
  contour: on a convex mask, which every slab-test silhouette of a box is,
  the contour's polygon holds exactly the mask's pixels).

The numbers, the largest over the frames:

* ``data_layout``: instances, buckets, views, target index, image size,
  validity and visibility that differ (a count);
* ``data_boxes``: the largest gap of a 2D box (pixels) or a 3D corner (m);
* ``data_camera``: the largest gap of K over its largest entry, and of a
  rectified extrinsic matrix's entries;
* ``data_masks``: the pixels whose soft mask at 0.5 differs from the written
  mask, over the written masks' pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("data_layout", "data_boxes", "data_camera", "data_masks")
BUCKETS = (8, 16, 24, 32)


def bucket(n: int) -> int:
    for size in BUCKETS:
        if n <= size:
            return size
    return -(-n // 8) * 8


def gravity_rotation(extrinsic: np.ndarray) -> np.ndarray:
    """``Q``: the rotation about the camera's x axis with ``Q g = e_y``, ``g``
    being the world axis nearest to the camera's y axis, in camera axes."""
    rot = np.asarray(extrinsic, np.float64)[:3, :3]
    g = rot @ np.round(rot[1])
    phi = math.atan2(-g[2], g[1])
    c, s = math.cos(phi), math.sin(phi)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rectified(extrinsics: np.ndarray, target: int) -> np.ndarray:
    """Each view's world-to-camera matrix rectified to the target (float64)."""
    rect = np.eye(4)
    rect[:3, :3] = gravity_rotation(extrinsics[target]).T
    return extrinsics @ np.linalg.inv(extrinsics[target]) @ rect


def passes(mask: torch.Tensor, min_area: int, min_box: int) -> bool:
    """A mask through an area filter and a box-size filter."""
    if int(mask.sum()) < max(min_area, 1):
        return False
    ys = torch.nonzero(mask.any(1)).flatten()
    xs = torch.nonzero(mask.any(0)).flatten()
    return min(int(xs[-1] - xs[0]), int(ys[-1] - ys[0])) >= min_box


def expected(truth: dict, filters: dict) -> dict:
    """What one target frame's ``FrameData`` should hold (see the module
    docstring): ``ids`` (the written cars in slot order), ``bucket``,
    ``visible`` [V, N], ``boxes_2d`` [V, N, 2, 2], ``boxes_3d`` [N, 8, 3],
    ``intrinsics``, ``extrinsics``."""
    masks, written, t = truth["masks"], truth["written"], truth["target_index"]
    views = masks.shape[0]

    def kept(v, i):
        if not written[v, i]:
            return False
        if v == t:
            return passes(masks[v, i], max(filters["min_mask_area"],
                                           filters["target_min_mask_area"]),
                          filters["target_min_box_size"])
        return passes(masks[v, i], filters["min_mask_area"], filters["min_box_size"])

    ids = [i for i in range(masks.shape[1]) if kept(t, i)]
    n, size = len(ids), bucket(len(ids))
    visible = np.zeros((views, size), bool)
    boxes_2d = np.zeros((views, size, 2, 2), np.float32)
    for v in range(views):
        for k, i in enumerate(ids):
            visible[v, k] = kept(v, i)
            if visible[v, k]:
                boxes_2d[v, k] = truth["boxes_2d"][v, i]
    boxes_3d = np.full((size, 8, 3), np.nan, np.float32)
    boxes_3d[:n] = truth["boxes_3d"][ids].astype(np.float32)
    return {"ids": ids, "bucket": size, "visible": visible, "boxes_2d": boxes_2d,
            "boxes_3d": boxes_3d, "intrinsics": truth["intrinsics"],
            "extrinsics": rectified(truth["extrinsics"], t), "target_index": t}


def unpack(packed: torch.Tensor, slots: int) -> torch.Tensor:
    """Bit ``k`` of each pixel's word -> ``[slots, pixels]`` (bool)."""
    shifts = torch.arange(slots, dtype=torch.int32, device=packed.device)
    return ((packed[None, :] >> shifts[:, None]) & 1).bool()


def camera_gap(intrinsics, extrinsics, want: dict) -> float:
    k_gap = np.abs(np.asarray(intrinsics, np.float64) - want["intrinsics"]).max()
    k_scale = np.abs(want["intrinsics"]).max()
    e_gap = np.abs(np.asarray(extrinsics, np.float64) - want["extrinsics"]).max()
    return float(max(k_gap / k_scale, e_gap))


def frame_numbers(built: dict, truth: dict, filters: dict, device) -> dict:
    """The numbers of one frame: ``built`` is what the driver built (its
    ``FrameData``'s fields on the host, the soft masks at 0.5 packed one bit
    a slot into ``masks`` [V H W])."""
    want = expected(truth, filters)
    views, size = want["visible"].shape
    h, w = truth["masks"].shape[-2:]
    n = len(want["ids"])
    valid = built["valid"].numpy()
    shapes = (built["intrinsics"].shape[0] == views and valid.shape[0] == size
              and tuple(built["image_size"]) == (h, w))
    if not shapes:
        return {name: math.inf for name in NUMBERS}
    layout = (int(valid.sum() != n) + int(np.sum(valid != (np.arange(size) < n)))
              + int(built["target_index"] != want["target_index"])
              + int(np.sum(built["visible"].numpy() != want["visible"])))
    boxes_3d = built["gt_boxes_3d"].numpy()
    pad_ok = np.isnan(boxes_3d[n:]).all()
    boxes = max(float(np.abs(built["gt_boxes_2d"].numpy() - want["boxes_2d"]).max()),
                float(np.abs(boxes_3d[:n] - want["boxes_3d"][:n]).max(initial=0.0))
                if pad_ok else math.inf)
    camera = camera_gap(built["intrinsics"].numpy(), built["extrinsics"].numpy(), want)
    differ = total = 0
    packed = built["masks"].to(device).reshape(views, h * w)
    for v in range(views):
        got = unpack(packed[v], size).reshape(size, h, w)
        written = torch.zeros(size, h, w, dtype=torch.bool, device=device)
        for k, i in enumerate(want["ids"]):
            if want["visible"][v, k]:
                written[k] = truth["masks"][v, i].to(device)
        differ += int((got != written).sum())
        total += int(written.sum())
    return {"data_layout": float(layout), "data_boxes": boxes, "data_camera": camera,
            "data_masks": differ / max(total, 1)}


def numbers(built: list, truth: list, filters: dict, device) -> dict:
    """The largest of each number over the targets; a target that the driver
    built no frame for counts in ``data_layout``."""
    out = {name: 0.0 for name in NUMBERS}
    for t, one in enumerate(truth):
        if built[t] is None:
            out["data_layout"] += 1.0
            continue
        one = dict(one, masks=one["masks"].to(device))
        for name, value in frame_numbers(built[t], one, filters, device).items():
            out[name] = max(out[name], value)
    return out


def camera_control(truth: list, filters: dict) -> float:
    """``data_camera`` of the reference's own K and rectified extrinsics
    rounded to bfloat16, the precision below the float32 the driver keeps."""
    gaps = []
    for one in truth:
        want = expected(one, filters)
        low = {k: torch.as_tensor(want[k]).to(torch.bfloat16).double().numpy()
               for k in ("intrinsics", "extrinsics")}
        gaps.append(camera_gap(low["intrinsics"], low["extrinsics"], want))
    return min(gaps)
