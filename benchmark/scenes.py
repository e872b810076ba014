"""The benchmark's scenes, made on the card from a seed.

A frozen copy of the scene math of the port's ``pipeline/frame.py``
(``synthetic_frame`` with ``layout="kitti"`` and ``build_frame_data``'s
assembly), moved from host numpy onto the device so that a run's set-up does
not spend seconds a frame on the host:

* a rig of ``views`` pinhole cameras translating along +z, the target in the
  middle (the KITTI-360 perspective image size);
* cars as boxes of half size (0.9, 0.8, 2.2) at z in [5, 80] m, |x| <= 0.3 z,
  yaw in [-0.4, 0.4] (drawn on the host with numpy, in ``synthetic_frame``'s
  order, a few numbers per frame);
* each car's mask in each view by a slab test along every pixel ray, clipped
  to [0.02, 0.98], its 2D box (the hit pixels' extent) and its visibility
  (8 hit pixels or more);
* the masks flattened over (view, y, x) in bfloat16, the sampling map (their
  max over instances), its top ``candidates`` pixels with ties broken by a
  seeded permutation, and their log weights.

Everything is returned as a dict of tensors named like the fields of the
port's ``FrameData``; nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_DIMS = (0.9, 0.8, 2.2)
CORNERS_UNIT = (
    (-1, -1, +1), (+1, -1, +1), (+1, -1, -1), (-1, -1, -1),
    (-1, +1, +1), (+1, +1, +1), (+1, +1, -1), (-1, +1, -1),
)
MASK_RANGE = (0.02, 0.98)
MIN_VISIBLE_PIXELS = 8


def cameras(views: int, image_size):
    """(intrinsics [V, 3, 3], extrinsics [V, 4, 4], target index), numpy f32."""
    h, w = image_size
    fx = w * 1.2
    intrinsic = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    intrinsics = np.tile(intrinsic, (views, 1, 1))
    offsets = np.linspace(-1.5, 1.5, views)
    target = int(np.argmin(np.abs(offsets)))
    offsets[target] = 0.0
    extrinsics = np.tile(np.eye(4, dtype=np.float32), (views, 1, 1))
    extrinsics[:, 2, 3] = -offsets
    return intrinsics, extrinsics, target


def layout(rng: np.random.Generator, instances: int):
    """Centres [n, 3] and yaws [n] of the cars, drawn as ``synthetic_frame``
    draws them with ``layout="kitti"``."""
    depths = rng.uniform(5, 80, instances)
    lateral = depths * rng.uniform(-0.3, 0.3, instances)
    centers = np.stack([lateral, rng.uniform(0.3, 0.8, instances), depths],
                       axis=-1).astype(np.float32)
    yaws = rng.uniform(-0.4, 0.4, instances).astype(np.float32)
    return centers, yaws


def yaw_rotations(yaws: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaws), np.sin(yaws)
    zero, one = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, zero, s], -1), np.stack([zero, one, zero], -1),
                     np.stack([-s, zero, c], -1)], -2).astype(np.float32)


def box_corners(centers, yaws, half_dims) -> np.ndarray:
    """World corners [n, 8, 3] of boxes, in the KITTI-360 evaluation order."""
    unit = np.asarray(CORNERS_UNIT, np.float32)
    rots = yaw_rotations(yaws)
    return np.stack([(unit * half_dims[i]) @ rots[i].T + centers[i]
                     for i in range(len(centers))]).reshape(-1, 8, 3)


def view_masks(intrinsic, extrinsic, centers, rots, half_dims, image_size, device):
    """Hit masks ``[n, H, W]`` (bool) of the boxes in one view, by a slab
    test along each pixel's ray."""
    h, w = image_size
    inv_k = np.linalg.inv(intrinsic)
    inv_e = np.linalg.inv(extrinsic)
    to_world = torch.as_tensor(inv_e[:3, :3] @ inv_k, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).to(torch.float32)
    dirs = pix @ to_world.T
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origin = inv_e[:3, 3]
    o = torch.as_tensor(np.einsum("nk,nkj->nj", origin - centers, rots), device=device)
    r = torch.as_tensor(rots, device=device)
    half = torch.as_tensor(half_dims, device=device)
    d = torch.einsum("hwk,nkj->nhwj", dirs, r)                         # [n, H, W, 3]
    t1 = (-half[:, None, None] - o[:, None, None]) / d
    t2 = (half[:, None, None] - o[:, None, None]) / d
    # numpy's nanmax / nanmin over the three slabs: a NaN slab bounds nothing
    near = torch.nan_to_num(torch.minimum(t1, t2), nan=-torch.inf).amax(-1)
    far = torch.nan_to_num(torch.maximum(t1, t2), nan=torch.inf).amin(-1)
    return (far >= near) & (far > 0)


def frame_scene(rng: np.random.Generator, tie_generator: torch.Generator, views: int,
                image_size, instances: int, max_instances: int, candidates: int,
                device) -> dict:
    """One frame's tensors on ``device`` (see the module docstring)."""
    h, w = image_size
    intrinsics, extrinsics, target = cameras(views, image_size)
    centers, yaws = layout(rng, instances)
    rots = yaw_rotations(yaws)
    half_dims = np.tile(np.asarray(HALF_DIMS, np.float32), (instances, 1))
    gt_3d = np.full((max_instances, 8, 3), np.nan, np.float32)
    gt_3d[:instances] = box_corners(centers, yaws, half_dims)

    flat = torch.empty(views, h, w, max_instances, dtype=torch.bfloat16, device=device)
    sampling = torch.empty(views, h, w, device=device)
    gt_2d = torch.zeros(views, max_instances, 2, 2, device=device)
    visible = torch.zeros(views, max_instances, dtype=torch.bool, device=device)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    for v in range(views):
        hit = view_masks(intrinsics[v], extrinsics[v], centers, rots, half_dims, image_size,
                         device)
        masks = torch.zeros(max_instances, h, w, device=device)
        masks[:instances] = hit.to(torch.float32)
        masks = masks.clamp_(*MASK_RANGE)
        flat[v] = masks.permute(1, 2, 0).to(torch.bfloat16)
        sampling[v] = masks.amax(0)
        cols, rows = hit.any(-2), hit.any(-1)                         # [n, W], [n, H]
        big = float(max(h, w))
        box = torch.stack([
            torch.where(cols, xs, big).amin(-1), torch.where(rows, ys, big).amin(-1),
            torch.where(cols, xs, -1.0).amax(-1), torch.where(rows, ys, -1.0).amax(-1),
        ], -1).reshape(instances, 2, 2)
        any_hit = cols.any(-1)
        gt_2d[v, :instances] = torch.where(any_hit[:, None, None], box, 0.0)
        visible[v, :instances] = hit.sum((-2, -1)) >= MIN_VISIBLE_PIXELS
    flat = flat.reshape(-1, max_instances)
    sampling = sampling.reshape(-1)

    # the top `candidates` pixels by weight, ties broken by a seeded
    # permutation, in order of descending weight
    k = min(candidates, sampling.numel())
    perm = torch.randperm(sampling.numel(), generator=tie_generator, device=device)
    order = torch.sort(sampling[perm], descending=True, stable=True).indices
    cand = perm[order[:k]]
    weights = sampling[cand]
    cand_weights = torch.where(weights > 0, torch.log(weights.clamp(
        min=torch.finfo(torch.float32).tiny)), -torch.inf)

    inv_k = np.linalg.inv(intrinsics)
    inv_e = np.linalg.inv(extrinsics)
    valid = np.zeros(max_instances, bool)
    valid[:instances] = True

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {
        "soft_masks_flat": flat,
        "sampling_weights": sampling,
        "candidate_indices": cand,
        "candidate_weights": cand_weights,
        "intrinsics": f32(intrinsics),
        "extrinsics": f32(extrinsics),
        "inv_projections": f32(inv_e[:, :3, :3] @ inv_k),
        "camera_positions": f32(inv_e[:, :3, 3]),
        "gt_boxes_2d": gt_2d,
        "visible": visible,
        "valid": torch.as_tensor(valid, device=device),
        "gt_boxes_3d": f32(gt_3d),
        "rectification": f32(np.eye(3)),
        "target_index": target,
        "image_size": (h, w),
        # the layout, for the initial boxes' draw
        "centers": centers,
        "yaws": yaws,
    }


def frame_seeds(seed: int, frames: int):
    """Per frame, the numpy generator of its layout and the seed of its
    tie-breaking permutation, both from ``seed``."""
    out = []
    for f in range(frames):
        seq = np.random.SeedSequence([seed % 2**64, 0x5CE7E, f])
        layout_seq, tie_seq = seq.spawn(2)
        out.append((np.random.default_rng(layout_seq),
                    int(tie_seq.generate_state(1, np.uint64)[0] >> 1)))
    return out


def make_scenes(seed: int, frames: int, cfg: dict, device) -> list[dict]:
    """``frames`` scenes of the configuration ``cfg`` from ``seed``."""
    scenes = []
    for rng, tie_seed in frame_seeds(seed, frames):
        tie = torch.Generator(device=device).manual_seed(tie_seed)
        scenes.append(frame_scene(rng, tie, cfg["views"], tuple(cfg["image_size"]),
                                  cfg["instances"], cfg["max_instances"],
                                  cfg["candidates"], device))
    return scenes


FRAME_FIELDS = ("soft_masks_flat", "sampling_weights", "candidate_indices",
                "candidate_weights", "intrinsics", "extrinsics", "inv_projections",
                "camera_positions", "gt_boxes_2d", "visible", "valid", "gt_boxes_3d",
                "rectification", "target_index", "image_size")


def stack(scenes: list[dict]) -> dict:
    """The scenes' frame fields with a leading frame axis (``target_index``
    as an int64 tensor), or the one scene's fields as they are."""
    if len(scenes) == 1:
        return {k: scenes[0][k] for k in FRAME_FIELDS}
    out = {}
    for key in FRAME_FIELDS:
        values = [s[key] for s in scenes]
        if key == "image_size":
            out[key] = values[0]
        elif key == "target_index":
            out[key] = torch.as_tensor(values, device=scenes[0]["valid"].device)
        else:
            out[key] = torch.stack(values)
    return out
