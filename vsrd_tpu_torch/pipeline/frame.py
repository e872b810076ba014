"""FrameData: one target frame and its source views as tensors on one device.

Counterpart of ``vsrd_tpu/pipeline/frame.py``. Everything here except the
final transfer is host numpy, written step for step like the JAX package,
so that the same integer seed gives a bit-identical frame:

* instances are padded to ``max_instances`` with a ``valid`` mask;
* soft masks are stored flattened over ``(view, y, x)`` in bfloat16, with
  the top-K candidate pixels of the max-over-instances sampling map and
  their log weights precomputed once per frame;
* ray directions are derived per step for just the sampled pixels.

A FrameData may also hold F equally shaped frames stacked along a leading
frame axis (``pipeline.sharded.stack_frames``), as the JAX package's
co-optimized frame batches do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FrameData:
    """One target frame + aligned source views, padded to static shapes.

    V = views (target at ``target_index``), N = max instances,
    P = V * H * W flattened pixels. All tensors live on one device. Stacked
    frames carry a leading frame axis on every tensor, and their
    ``target_index`` is an int64 tensor ``[F]``.
    """

    soft_masks_flat: torch.Tensor    # [P, N] bf16 — target-aligned soft masks
    sampling_weights: torch.Tensor   # [P] f32 — max-over-instances soft mask
    candidate_indices: torch.Tensor  # [K] int64 — top-K pixels by weight
    candidate_weights: torch.Tensor  # [K] f32 — their LOG sampling weights
    intrinsics: torch.Tensor         # [V, 3, 3]
    extrinsics: torch.Tensor         # [V, 4, 4] (world -> camera, rectified)
    inv_projections: torch.Tensor    # [V, 3, 3] = R^T K^-1 (pixel -> world dir)
    camera_positions: torch.Tensor   # [V, 3]
    gt_boxes_2d: torch.Tensor        # [V, N, 2, 2] zeros where invisible
    visible: torch.Tensor            # [V, N] bool
    valid: torch.Tensor              # [N] bool — real target instances
    gt_boxes_3d: torch.Tensor        # [N, 8, 3] target GT (NaN where absent)
    rectification: torch.Tensor      # [3, 3]
    target_index: int | torch.Tensor  # position of the target view ([F] if stacked)
    image_size: tuple[int, int]      # (H, W)
    gray_images: torch.Tensor | None = None  # [V, H, W], photometric only

    @property
    def num_views(self) -> int:
        return self.intrinsics.shape[-3]

    @property
    def max_instances(self) -> int:
        return self.valid.shape[-1]

    @property
    def num_frames(self) -> int | None:
        """Leading frame-axis size, or None for a single frame."""
        return self.valid.shape[0] if self.valid.ndim == 2 else None

    @property
    def device(self) -> torch.device:
        return self.valid.device


def ray_directions_at(frame: FrameData, flat_indices: torch.Tensor):
    """(origin, direction) for flattened pixel indices ``[R]``, or ``[F, R]``
    into stacked frames (row f indexes frame f).

    Index layout is the reference's flatten order (view, y, x).
    """
    height, width = frame.image_size
    pixels_per_view = height * width
    view = flat_indices // pixels_per_view
    if frame.num_frames is not None:
        frames = torch.arange(frame.num_frames, device=view.device)[:, None]
        view = (frames, view)
    rem = flat_indices % pixels_per_view
    dtype = frame.inv_projections.dtype
    py = (rem // width).to(dtype)
    px = (rem % width).to(dtype)

    pix_h = torch.stack([px, py, torch.ones_like(px)], dim=-1)   # [R, 3]
    inv_p = frame.inv_projections[view]                          # [R, 3, 3]
    # elementwise mul + reduce, as in the JAX package: the box-SDF gradient
    # is discontinuous at facet boundaries, so even 1e-7 of direction noise
    # flips isolated samples
    directions = torch.sum(inv_p * pix_h[..., None, :], dim=-1)
    directions = directions / torch.clamp(
        torch.linalg.vector_norm(directions, dim=-1, keepdim=True), min=1e-12
    )
    origins = frame.camera_positions[view]
    return origins, directions


def build_frame_data(
    images_or_none,
    soft_masks,      # list over V of np [N_v, H, W] target-aligned (zeros ok)
    intrinsics,      # np [V, 3, 3]
    extrinsics,      # np [V, 4, 4] rectified
    gt_boxes_2d,     # np [V, N, 2, 2]
    visible,         # np [V, N] bool
    valid,           # np [N] bool
    gt_boxes_3d,     # np [N, 8, 3]
    rectification,   # np [3, 3]
    target_index: int,
    max_instances: int | None = None,
    num_candidates: int = 1 << 18,
    device: torch.device | str = "cuda",
) -> FrameData:
    """Assemble a FrameData on ``device`` (the card unless the caller asks
    for another) from host-side numpy arrays.

    ``soft_masks`` entries must already be aligned to target instance
    order and zero-filled for invisible instances.
    """
    soft = np.stack(soft_masks, axis=0)  # [V, N, H, W]
    v, n, h, w = soft.shape
    if max_instances is not None and n < max_instances:
        pad = max_instances - n
        soft = np.pad(soft, ((0, 0), (0, pad), (0, 0), (0, 0)))
        gt_boxes_2d = np.pad(gt_boxes_2d, ((0, 0), (0, pad), (0, 0), (0, 0)))
        visible = np.pad(visible, ((0, 0), (0, pad)))
        valid = np.pad(valid, (0, pad))
        gt_boxes_3d = np.pad(
            gt_boxes_3d, ((0, pad), (0, 0), (0, 0)), constant_values=np.nan
        )
        n = max_instances

    flat = soft.transpose(0, 2, 3, 1).reshape(-1, n)  # [(V H W), N]
    sampling = flat.max(axis=-1).astype(np.float32)

    # Top-K candidate pixels by sampling weight, ties broken by a seeded
    # permutation so that a tied plateau larger than K is sampled
    # uniformly; then sorted by descending weight (same order as the JAX
    # package, which the bit-identity test relies on).
    k = min(num_candidates, sampling.size)
    if k < sampling.size:
        tie_rng = np.random.default_rng(0x5A3D)
        perm = tie_rng.permutation(sampling.size).astype(np.int64)
        cand = perm[
            np.argpartition(sampling[perm], -k)[-k:]
        ].astype(np.int32)
    else:
        cand = np.arange(sampling.size, dtype=np.int32)
    cand = cand[np.argsort(-sampling[cand], kind="stable")]
    with np.errstate(divide="ignore"):
        cand_weights = np.where(
            sampling[cand] > 0,
            np.log(np.maximum(sampling[cand], np.finfo(np.float32).tiny)),
            -np.inf,
        ).astype(np.float32)

    inv_k = np.linalg.inv(intrinsics)
    inv_e = np.linalg.inv(extrinsics)
    inv_p = inv_e[:, :3, :3] @ inv_k
    cam = inv_e[:, :3, 3]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    gray = None
    if images_or_none is not None:
        stack = np.stack(images_or_none).astype(np.float32)  # [V, H, W, 3]
        gray = f32(stack @ np.asarray([0.299, 0.587, 0.114], np.float32))

    return FrameData(
        soft_masks_flat=torch.from_numpy(np.ascontiguousarray(flat))
        .to(torch.bfloat16)
        .to(device),
        sampling_weights=f32(sampling),
        candidate_indices=torch.as_tensor(cand.astype(np.int64), device=device),
        candidate_weights=f32(cand_weights),
        intrinsics=f32(intrinsics),
        extrinsics=f32(extrinsics),
        inv_projections=f32(inv_p),
        camera_positions=f32(cam),
        gt_boxes_2d=f32(gt_boxes_2d),
        visible=torch.as_tensor(np.asarray(visible, bool), device=device),
        valid=torch.as_tensor(np.asarray(valid, bool), device=device),
        gt_boxes_3d=f32(gt_boxes_3d),
        rectification=f32(rectification),
        target_index=int(target_index),
        image_size=(h, w),
        gray_images=gray,
    )


def synthetic_frame(
    seed: int,
    num_views: int = 4,
    image_size: tuple[int, int] = (96, 128),
    num_instances: int = 3,
    max_instances: int = 4,
    seed_boxes: np.ndarray | None = None,
    with_images: bool = False,
    num_candidates: int = 1 << 18,
    layout: str = "compact",
    device: torch.device | str = "cuda",
) -> FrameData:
    """A synthetic multi-view scene with ground-truth boxes: cars as boxes
    in front of a camera rig moving along +z, masks rendered analytically
    by slab tests along each pixel ray.

    ``seed`` seeds the numpy generator directly; the JAX package draws the
    same integer from its key (``jax.random.randint(key, (), 0, 2**31 -
    1)``), so both build a bit-identical frame from it.

    ``layout="compact"`` places instances at z in [8, 16], x in [-4, 4];
    ``layout="kitti"`` spreads them over z in [5, 80] with |x| <= 0.3 z.
    """
    rng = np.random.default_rng(int(seed))
    h, w = image_size

    fx = w * 1.2
    intrinsic = np.array(
        [[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32
    )
    intrinsics = np.tile(intrinsic, (num_views, 1, 1))

    # camera rig: translating along z (world frame = target camera frame)
    extrinsics = []
    offsets = np.linspace(-1.5, 1.5, num_views)
    target_index = int(np.argmin(np.abs(offsets)))
    offsets[target_index] = 0.0
    for off in offsets:
        e = np.eye(4, dtype=np.float32)
        e[2, 3] = -off  # camera at z=off looking down +z
        extrinsics.append(e)
    extrinsics = np.stack(extrinsics)

    if seed_boxes is None:
        if layout == "kitti":
            depths = rng.uniform(5, 80, num_instances)
            lateral = depths * rng.uniform(-0.3, 0.3, num_instances)
            centers = np.stack(
                [lateral, rng.uniform(0.3, 0.8, num_instances), depths],
                axis=-1,
            ).astype(np.float32)
        else:
            centers = np.stack(
                [
                    rng.uniform(-4, 4, num_instances),
                    rng.uniform(0.3, 0.8, num_instances),
                    rng.uniform(8, 16, num_instances),
                ],
                axis=-1,
            ).astype(np.float32)
    else:
        centers = seed_boxes[:, :3].astype(np.float32)
        num_instances = len(centers)
    half_dims = np.tile(np.array([0.9, 0.8, 2.2], np.float32), (num_instances, 1))
    yaws = rng.uniform(-0.4, 0.4, num_instances).astype(np.float32)

    corners_unit = np.array(
        [
            [-1, -1, +1], [+1, -1, +1], [+1, -1, -1], [-1, -1, -1],
            [-1, +1, +1], [+1, +1, +1], [+1, +1, -1], [-1, +1, -1],
        ],
        np.float32,
    )
    gt_boxes_3d = np.full((max_instances, 8, 3), np.nan, np.float32)
    soft_masks = []
    gt_boxes_2d = np.zeros((num_views, max_instances, 2, 2), np.float32)
    visible = np.zeros((num_views, max_instances), bool)

    rots = []
    for i in range(num_instances):
        c, s = np.cos(yaws[i]), np.sin(yaws[i])
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        rots.append(rot)
        gt_boxes_3d[i] = (corners_unit * half_dims[i]) @ rot.T + centers[i]

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)

    for v in range(num_views):
        inv_k = np.linalg.inv(intrinsics[v])
        inv_e = np.linalg.inv(extrinsics[v])
        dirs = pix @ (inv_e[:3, :3] @ inv_k).T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origin = inv_e[:3, 3]
        masks_v = np.zeros((max_instances, h, w), np.float32)
        for i in range(num_instances):
            # slab test in the instance frame
            o = (origin - centers[i]) @ rots[i]
            d = dirs @ rots[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (-half_dims[i] - o) / d
                t2 = (half_dims[i] - o) / d
            tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (tmax >= tmin) & (tmax > 0)
            masks_v[i] = hit.astype(np.float32)
            if hit.any():
                yy, xx = np.nonzero(hit)
                gt_boxes_2d[v, i] = [[xx.min(), yy.min()], [xx.max(), yy.max()]]
                visible[v, i] = hit.sum() >= 8
        soft_masks.append(np.clip(masks_v, 0.02, 0.98))

    valid = np.zeros(max_instances, bool)
    valid[:num_instances] = True

    images = None
    if with_images:
        images = [
            np.clip(
                masks.max(0)[..., None] * rng.uniform(0.4, 0.9)
                + rng.random((h, w, 1)) * 0.3,
                0.0, 1.0,
            ).repeat(3, axis=-1).astype(np.float32)
            for masks in soft_masks
        ]

    return build_frame_data(
        images,
        soft_masks,
        intrinsics,
        extrinsics,
        gt_boxes_2d,
        visible,
        valid,
        gt_boxes_3d,
        np.eye(3, dtype=np.float32),
        target_index,
        num_candidates=num_candidates,
        device=device,
    )
