"""Per-frame test-time optimization: the Adam loop that auto-labels a frame.

Counterpart of ``vsrd_tpu/pipeline/optimize.py``. One
step (``train_step``) decodes the boxes, projects them into every view,
matches them to the target view's ground-truth boxes on the device,
computes the DIoU and smooth-L1 projection losses, renders Gumbel-top-k
sampled rays through the softmin union of the box SDFs (plus, after
warmup, each instance's residual field from the hypernetwork) with
hierarchical NeuS, and adds the silhouette BCE and the eikonal loss.

The field is evaluated by the kernels of ``rendering/field_kernels.py``
(K1/K2 for the fine pass, K3 for the box-only coarse pass); on CPU
tensors they run their plain twins. The loop runs in Python with no host
synchronisation inside a chunk: the step index, the phase and the
metric cadence are host integers, and the per-step scalars are copied to
the host once per chunk.

Co-optimized frame batches (``optimize_frames_batched``): a FrameData with
a leading frame axis (``sharded.stack_frames``) and params and Adam
moments with the same leading axis run through the same functions. Every
op takes the frame axis as a batch dimension, so a step makes the
launches of one frame whatever F is, and the field goes through ONE launch
of each kernel with a frame grid axis (K4a/K4c/K4b). The per-frame losses
come back as ``[F]`` and are summed for the gradient; frames share the
step's random stream and the Adam step count, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models import box_parameters, hyper_field
from ..ops import geometry, iou2d, iou3d, matching, sampling
from ..rendering import field_kernels, renderer
from .frame import FrameData, ray_directions_at


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Hyperparameters, with the JAX package's fields and defaults.

    The ``kernel_*`` knobs are the ``pallas_*`` knobs of the JAX package
    with the same meaning. JAX fields without a counterpart here:

    * ``use_pallas``, ``field_dtype`` and ``remat_fields``: they choose
      and configure the XLA field path. The port has no such path; its
      field always goes through the kernels in f32 (their plain twins on
      CPU tensors), as the JAX package's kernel path does.
    * ``pallas_rev_grad``: K1 always computes grad_x u by the JAX
      kernel's default ``rev_grad`` form, one reverse sweep per instance.
      The JAX package's other form, three forward tangents, serves its
      strict mode, where the MXU's default precision is not f32; K1's
      tensor-core products run in 3xTF32, f32-accurate at any
      ``kernel_matmul_precision``, so the port has one form.
    * ``pallas_tile``, ``pallas_bwd_tile``, ``pallas_box_tile``: the CUDA
      kernels choose their own launch shapes.
    """

    num_steps: int = 3000
    warmup_steps: int = 1000
    # volume rendering
    num_rays: int = 1000
    num_samples: int = 100          # coarse = fine = 100
    distance_range: tuple[float, float] = (0.0, 100.0)
    max_sdf_union_temperature: float = 1.0
    min_sdf_union_temperature: float = 0.1
    max_sdf_std_deviation: float = 1.0
    min_sdf_std_deviation: float = 0.1
    # loss weights
    iou_projection_weight: float = 0.1
    l1_projection_weight: float = 1.0
    silhouette_weight: float = 1.0
    eikonal_weight: float = 0.01
    photometric_weight: float = 0.0   # the photometric branch is not ported
    # surface rendering (photometric branch)
    surface_num_rays: int = 100
    surface_num_iterations: int = 1000
    surface_convergence_criteria: float = 0.01
    surface_bounding_radius: float = 100.0
    surface_patch_size: tuple[int, int] = (11, 11)
    # optimizer
    box_lr: float = 0.01
    embedding_lr: float = 1e-3
    hypernetwork_lr: float = 1e-4
    lr_decay: float = 0.01 ** (1.0 / 3000.0)
    # model
    num_features: int = 256
    num_frequencies: int = 8
    field_channels: tuple[int, ...] = (16, 16, 16, 16)
    hyper_channels: tuple[int, ...] = (256, 256, 256, 256)
    # numerics
    checkpoint_interval: int = 500
    metric_interval: int = 50
    # 'default': fast mode; 'highest': strict parity mode, which turns the
    # directional coarse pass off (the kernels compute in f32 either way)
    kernel_matmul_precision: str = "default"
    # coarse pass through K3's single directional tangent instead of the
    # full spatial gradient (off in strict mode)
    kernel_dir_coarse: bool = True
    # coarse pass on the box SDF union only (no residual MLP): the residual
    # is non-negative, so the true surface lies inside the box isosurface
    # and the fine pass corrects the placement (same gating as above)
    kernel_box_coarse: bool = True
    # per-tile instance-group skipping (off by default in the JAX package
    # too) is not ported; True raises
    kernel_group_skip: bool = False
    # parity/debug mode: midpoint quadrature + linspace importance samples
    deterministic: bool = False

    @property
    def position_scale(self) -> float:
        return max(self.distance_range)


def cosine_annealing(progress, maximum, minimum):
    """(cos(pi x) + 1)/2 * (a - b) + b."""
    return (torch.cos(math.pi * progress) + 1.0) / 2.0 * (maximum - minimum) + minimum


def init_params(generator: torch.Generator, max_instances: int, cfg: OptimizationConfig,
                device: torch.device | str | None = None):
    """Per-frame learnable parameters: box parameters + hypernetwork, as
    nested dicts of tensors (the JAX pytree's layout), on ``device`` (by
    default the generator's)."""
    boxes = box_parameters.init_box_parameters(
        generator, 1, max_instances, cfg.num_features, device=device)
    boxes = {k: v[0] for k, v in boxes.items()}
    hyper = hyper_field.init_hyper_field(
        generator,
        in_channels=3 * cfg.num_frequencies * 2,
        out_channels_list=cfg.field_channels,
        hyper_in_channels=cfg.num_features,
        hyper_out_channels_list=cfg.hyper_channels,
        device=device,
    )
    return {"boxes": boxes, "hyper": hyper}


def init_params_batched(seed: int, num_frames: int, max_instances: int,
                        cfg: OptimizationConfig, device: torch.device | str = "cuda"):
    """Independent per-frame params stacked along a leading frame axis.
    Frame f takes the f-th draw of one CPU generator seeded with ``seed``,
    so frame 0 starts where ``optimize_frame(frame, seed)`` starts."""
    generator = torch.Generator(device="cpu").manual_seed(seed)
    per_frame = [init_params(generator, max_instances, cfg) for _ in range(num_frames)]
    return tree_map(lambda t: t.to(device), tree_stack(per_frame))


def tree_leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested dict/list of tensors, in a fixed order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for index, item in enumerate(tree):
            yield from tree_leaves(item, prefix + (index,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_stack(trees):
    """Equally structured trees -> one tree of their leaves stacked on a
    new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(items)) for items in zip(*trees))
    return torch.stack(trees)


class Adam:
    """Adam with per-group learning rates and exponential decay.

    Box parameters learn at ``box_lr``, embeddings at ``embedding_lr``,
    the hypernetwork at ``hypernetwork_lr``; every rate decays by
    ``lr_decay ** count``. The reference's torch.optim.Adam skips
    parameters without a gradient, so the embeddings and the hypernetwork
    (first used after warmup) start their step count there: their bias
    correction runs ``warmup_steps`` behind. Without that offset their
    first update is about 2x too small. The state is ``{"mu", "nu",
    "count"}`` like the JAX optimizer's; updates are made in place.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: OptimizationConfig):
        self.cfg = cfg

    def _group(self, path):
        """(learning rate, bias-correction offset) of a parameter path."""
        if path[0] == "hyper":
            return self.cfg.hypernetwork_lr, float(self.cfg.warmup_steps)
        if path[1] == "embeddings":
            return self.cfg.embedding_lr, float(self.cfg.warmup_steps)
        return self.cfg.box_lr, 0.0

    def init(self, params):
        zeros = lambda t: torch.zeros_like(t)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "count": 0}

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` and ``state`` in place from ``grads`` (a list
        aligned with ``tree_leaves(params)``; ``None`` counts as zero)."""
        # scalars in f32, in the JAX optimizer's order of operations
        f32 = np.float32
        c = f32(state["count"])
        decay = f32(self.cfg.lr_decay) ** c
        b1, b2 = f32(self.b1), f32(self.b2)
        mus = [t for _, t in tree_leaves(state["mu"])]
        nus = [t for _, t in tree_leaves(state["nu"])]
        for (path, p), g, m, v in zip(tree_leaves(params), grads, mus, nus):
            lr, offset = self._group(path)
            m.mul_(self.b1)
            v.mul_(self.b2)
            if g is not None:
                m.add_(g, alpha=1.0 - self.b1)
                v.addcmul_(g, g, value=1.0 - self.b2)
            t = max(c + f32(1.0) - f32(offset), f32(1.0))
            m_hat = m / float(f32(1.0) - b1 ** t)
            v_hat = v / float(f32(1.0) - b2 ** t)
            p.add_(float(f32(-lr) * decay) * m_hat / (torch.sqrt(v_hat) + self.eps))
        state["count"] += 1


def _project_boxes_all_views(corners_world, frame: FrameData):
    """World corners [(F,) N, 8, 3] -> camera corners [(F,) V, N, 8, 3] and
    clipped 2D boxes [(F,) V, N, 2, 2] in every view."""
    cam = geometry.transform_points(frame.extrinsics[..., :, None, :, :],
                                    corners_world[..., None, :, :, :])
    boxes_2d = geometry.project_box_3d(cam, frame.intrinsics[..., :, None, :, :])
    return cam, geometry.clip_boxes_to_image(boxes_2d, frame.image_size)


def _at_target(x, frame: FrameData):
    """``x [(F,) V, ...]`` in each frame's target view: ``[(F,) ...]``."""
    if frame.num_frames is None:
        return x[frame.target_index]
    return x[torch.arange(frame.num_frames, device=x.device), frame.target_index]


def _masked_mean(values, mask, dim, epsilon=1e-12):
    mask = torch.broadcast_to(mask, values.shape).to(values.dtype)
    return torch.sum(values * mask, dim=dim) / torch.clamp(torch.sum(mask, dim=dim), min=epsilon)


def _binary_cross_entropy(probs, targets, epsilon=1e-6):
    probs = torch.clamp(probs, epsilon, 1.0 - epsilon)
    return -(targets * torch.log(probs) + (1.0 - targets) * torch.log1p(-probs))


def compute_loss(params, frame: FrameData, step: int, cfg: OptimizationConfig,
                 use_rdf: bool, generator: torch.Generator | None = None,
                 ray_indices: torch.Tensor | None = None):
    """One forward pass: projection + silhouette (+ eikonal) losses.

    ``use_rdf`` selects the post-warmup phase (residual field + eikonal).
    ``ray_indices [(F,) R]`` overrides the per-step ray draw with flat
    (view, y, x) pixel indices, so that two implementations can render
    identical rays. Returns ``(total, aux)``.

    Stacked frames (a leading frame axis on ``frame`` and ``params``) give
    a per-frame ``total [F]``: every reduction keeps the frame axis, and
    each frame's params only reach its own loss.
    """
    if cfg.photometric_weight > 0.0:
        raise NotImplementedError("the photometric branch is not ported")
    if cfg.kernel_group_skip:
        raise NotImplementedError("per-tile instance-group skipping is not ported")
    n = frame.max_instances
    device = frame.device
    lead = frame.valid.shape[:-1]      # (F,) for stacked frames, () for one

    def frame_mean(values, mask):
        """Masked mean over every axis but the leading frame axis."""
        return _masked_mean(values, mask, dim=tuple(range(len(lead), values.ndim)))

    # ---------------- projection + matching ----------------
    decoded = box_parameters.decode_boxes(params["boxes"])
    cam_corners, pd_boxes_2d = _project_boxes_all_views(decoded["boxes_3d"], frame)
    pd_flat = _at_target(pd_boxes_2d, frame).reshape(*lead, n, 4)
    gt_flat = _at_target(frame.gt_boxes_2d, frame).reshape(*lead, n, 4)
    cost = -iou2d.distance_box_iou(pd_flat, gt_flat)
    row_to_col = matching.masked_linear_sum_assignment(cost.detach(), frame.valid, frame.valid)

    gt_matched = torch.take_along_dim(frame.gt_boxes_2d, row_to_col[..., None, :, None, None],
                                      dim=-3)
    vis_matched = torch.take_along_dim(frame.visible, row_to_col[..., None, :], dim=-1)
    pair_mask = vis_matched & frame.valid[..., None, :]
    pd_xyxy = pd_boxes_2d.reshape(*lead, -1, n, 4)
    gt_xyxy = gt_matched.reshape(*lead, -1, n, 4)
    iou_loss = frame_mean(iou2d.distance_box_iou_loss(pd_xyxy, gt_xyxy), pair_mask)
    l1_loss = frame_mean(iou2d.smooth_l1(pd_xyxy, gt_xyxy), pair_mask[..., None])

    # ---------------- annealing (f32, as in the JAX package) ----------------
    progress = torch.tensor(step, dtype=torch.float32, device=device) / cfg.num_steps
    temperature = cosine_annealing(
        progress, cfg.max_sdf_union_temperature, cfg.min_sdf_union_temperature)
    std = cosine_annealing(progress, cfg.max_sdf_std_deviation, cfg.min_sdf_std_deviation)
    cosine_ratio = progress

    # ---------------- scene field ----------------
    field_weights = None
    if use_rdf:
        field_weights = hyper_field.hypernetwork_apply(params["hyper"], decoded["embeddings"])
    locations = decoded["locations"]
    rotations = decoded["orientations"]
    half_dims = decoded["dimensions"]
    valid_f = frame.valid.to(torch.float32)
    scale = cfg.position_scale

    # positions [(F,) R, S, 3] go to the kernels as [(F,) R * S, 3]
    def field_with_grad(positions):
        shape = positions.shape[:-1]
        u, w, g = field_kernels.fused_field_with_grad(
            positions.reshape(*lead, -1, 3), locations, rotations, half_dims, valid_f,
            field_weights, temperature, scale)
        return u.reshape(shape), w.reshape(*shape, n), g.reshape(*shape, 3)

    field_with_dirgrad_coarse = None
    if cfg.kernel_dir_coarse and cfg.kernel_matmul_precision != "highest":
        coarse_weights = None if (cfg.kernel_box_coarse and use_rdf) else field_weights

        def field_with_dirgrad_coarse(positions, directions):
            shape = positions.shape[:-1]
            u, w, ud = field_kernels.fused_field_dir_forward(
                positions.reshape(*lead, -1, 3), directions.reshape(*lead, -1, 3),
                locations, rotations, half_dims, valid_f,
                None if coarse_weights is None else coarse_weights.detach(),
                temperature, scale)
            return u.reshape(shape), w.reshape(*shape, n), ud.reshape(shape)

    # ---------------- silhouette rendering ----------------
    if ray_indices is None:
        cand_idx = sampling.multinomial_logits(
            frame.candidate_weights, cfg.num_rays, generator=generator)
        ray_idx = torch.take_along_dim(frame.candidate_indices, cand_idx, dim=-1)
    else:
        ray_idx = ray_indices.long()
    origins, directions = ray_directions_at(frame, ray_idx)

    out = renderer.hierarchical_render(
        origins, directions, cfg.distance_range, cfg.num_samples, std, cosine_ratio,
        field_with_grad=field_with_grad,
        field_with_dirgrad_coarse=field_with_dirgrad_coarse,
        deterministic=cfg.deterministic, generator=generator,
    )
    rendered = out.features  # [(F,) R, N] per-ray instance probabilities

    targets = torch.take_along_dim(frame.soft_masks_flat, ray_idx[..., None], dim=-2)
    targets = torch.take_along_dim(targets.to(rendered.dtype), row_to_col[..., None, :], dim=-1)
    bce = _binary_cross_entropy(rendered, targets)
    silhouette_loss = frame_mean(bce, frame.valid[..., None, :])

    losses = {
        "iou_projection_loss": iou_loss,
        "l1_projection_loss": l1_loss,
        "silhouette_loss": silhouette_loss,
    }
    zero = torch.zeros(lead, device=device)
    if use_rdf:
        norms = torch.linalg.vector_norm(out.gradients, dim=-1)
        losses["eikonal_loss"] = torch.mean(torch.square(norms - 1.0), dim=(-2, -1))
    else:
        losses["eikonal_loss"] = zero
    losses["photometric_loss"] = zero

    total = (
        cfg.iou_projection_weight * losses["iou_projection_loss"]
        + cfg.l1_projection_weight * losses["l1_projection_loss"]
        + cfg.silhouette_weight * losses["silhouette_loss"]
        + cfg.eikonal_weight * losses["eikonal_loss"]
        + cfg.photometric_weight * losses["photometric_loss"]
    )
    aux = {
        "losses": losses,
        "total": total,
        "row_to_col": row_to_col,
        "cam_corners_target": _at_target(cam_corners, frame),
        "temperature": temperature,
        "sdf_std_deviation": std,
    }
    return total, aux


METRIC_NAMES = ("iou_3d", "iou_bev", "accuracy_3d_25", "accuracy_bev_25",
                "accuracy_3d_50", "accuracy_bev_50", "num_matched")


def compute_metrics(frame: FrameData, cam_corners_target, row_to_col):
    """3D/BEV IoU and accuracies of the matched boxes against the GT, per
    frame for stacked frames (the box pairs of all frames go through
    ``box_3d_iou`` as one flat batch)."""
    rect_t = frame.rectification.transpose(-2, -1)[..., None, :, :]   # [(F,) 1, 3, 3]
    pd = cam_corners_target @ rect_t                                  # [(F,) N, 8, 3]
    gt = torch.take_along_dim(frame.gt_boxes_3d, row_to_col[..., None, None], dim=-3) @ rect_t
    rot = geometry.rotation_matrix_x(-math.pi / 2.0).to(pd.device)
    pd = pd @ rot.T
    gt_rotated = gt @ rot.T

    finite = torch.all(torch.isfinite(gt.flatten(-2)), dim=-1)
    mask = finite & frame.valid
    gt_safe = torch.where(mask[..., None, None], gt_rotated, 1.0)

    iou_3d, iou_bev = iou3d.box_3d_iou(pd.reshape(-1, 8, 3), gt_safe.reshape(-1, 8, 3))
    iou_3d = torch.where(mask, iou_3d.reshape(mask.shape), 0.0)
    iou_bev = torch.where(mask, iou_bev.reshape(mask.shape), 0.0)
    f = lambda x: x.to(torch.float32)  # noqa: E731
    return {
        "iou_3d": _masked_mean(iou_3d, mask, dim=-1),
        "iou_bev": _masked_mean(iou_bev, mask, dim=-1),
        "accuracy_3d_25": _masked_mean(f(iou_3d > 0.25), mask, dim=-1),
        "accuracy_bev_25": _masked_mean(f(iou_bev > 0.25), mask, dim=-1),
        "accuracy_3d_50": _masked_mean(f(iou_3d > 0.50), mask, dim=-1),
        "accuracy_bev_50": _masked_mean(f(iou_bev > 0.50), mask, dim=-1),
        "num_matched": torch.sum(f(mask), dim=-1),
    }


def train_step(params, opt_state, frame: FrameData, step: int, cfg: OptimizationConfig,
               optimizer: Adam, generator: torch.Generator | None = None,
               ray_indices: torch.Tensor | None = None):
    """One optimization step with the warmup phase switch; updates
    ``params`` and ``opt_state`` in place and returns the step's scalars
    as device tensors (0-d, or ``[F]`` for stacked frames, whose per-frame
    losses are summed for the gradient)."""
    use_rdf = step >= cfg.warmup_steps
    leaves = [t for _, t in tree_leaves(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    total, aux = compute_loss(params, frame, step, cfg, use_rdf, generator, ray_indices)
    grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    optimizer.step(params, grads, opt_state)

    lead = frame.valid.shape[:-1]
    if (step + 1) % cfg.metric_interval == 0:
        metrics = compute_metrics(frame, aux["cam_corners_target"].detach(), aux["row_to_col"])
    else:
        zero = torch.zeros(lead, device=frame.device)
        metrics = {name: zero for name in METRIC_NAMES}
    return {
        "loss": total.detach(),
        **{k: v.detach() for k, v in aux["losses"].items()},
        **metrics,
        "temperature": aux["temperature"].expand(lead),
        "sdf_std_deviation": aux["sdf_std_deviation"].expand(lead),
    }


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The per-step random stream: a pure function of (seed, step), so that
    a run resumed at step k continues the same stream."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def optimize_chunk(params, opt_state, frame: FrameData, seed: int, start_step: int,
                   cfg: OptimizationConfig, num_steps: int, optimizer: Adam | None = None):
    """Run ``num_steps`` steps from ``start_step``; returns the per-step
    scalars stacked (``[steps]``, or ``[steps, F]`` for stacked frames) and
    copied to the host once."""
    optimizer = optimizer or Adam(cfg)
    scalars = []
    for step in range(start_step, start_step + num_steps):
        gen = step_generator(seed, step, frame.device)
        scalars.append(train_step(params, opt_state, frame, step, cfg, optimizer, gen))
    return {k: torch.stack([s[k] for s in scalars]).cpu().numpy() for k in scalars[0]}


def optimize_frame(frame: FrameData, seed: int,
                   cfg: OptimizationConfig = OptimizationConfig(),
                   callback=None, init_state=None):
    """Full per-frame optimization in checkpoint-sized chunks.

    ``callback(step, params, scalars_chunk, opt_state)`` runs on the host
    after every chunk. ``init_state = (params, opt_state, start_step)``
    resumes a frame. Returns the final params and the per-step scalars
    (numpy arrays over all steps).
    """
    device = frame.device
    optimizer = Adam(cfg)
    if init_state is None:
        init_gen = torch.Generator(device="cpu").manual_seed(seed)
        params = tree_map(lambda t: t.to(device),
                          init_params(init_gen, frame.max_instances, cfg))
        opt_state = optimizer.init(params)
        step = 0
    else:
        params, opt_state, step = init_state

    all_scalars = []
    while step < cfg.num_steps:
        size = min(cfg.checkpoint_interval, cfg.num_steps - step)
        chunk = optimize_chunk(params, opt_state, frame, seed, step, cfg, size, optimizer)
        all_scalars.append(chunk)
        step += size
        if callback is not None:
            callback(step, params, chunk, opt_state)
    stacked = {k: np.concatenate([c[k] for c in all_scalars]) for k in all_scalars[0]}
    return params, stacked


def optimize_frames_batched(frames: FrameData, seed: int,
                            cfg: OptimizationConfig = OptimizationConfig(), callback=None):
    """Co-optimize ``F`` stacked frames (``sharded.stack_frames``) on one
    device: one step runs every frame, through one launch of each field
    kernel. The frames are independent (each one's params get only its own
    loss's gradient), their params come from ``init_params_batched(seed)``
    and they share the per-step random stream. Returns the stacked final
    params and the per-step scalars ``[steps, F]``; ``callback`` as in
    ``optimize_frame``.
    """
    params = init_params_batched(seed, frames.num_frames, frames.max_instances, cfg,
                                 device=frames.device)
    return optimize_frame(frames, seed, cfg, callback,
                          init_state=(params, Adam(cfg).init(params), 0))
