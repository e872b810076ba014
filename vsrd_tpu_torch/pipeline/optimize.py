"""Per-frame test-time optimization: the Adam loop that auto-labels a frame.

Counterpart of ``vsrd_tpu/pipeline/optimize.py``. One
step (``train_step``) decodes the boxes, projects them into every view,
matches them to the target view's ground-truth boxes on the device,
computes the DIoU and smooth-L1 projection losses, renders Gumbel-top-k
sampled rays through the softmin union of the box SDFs (plus, after
warmup, each instance's residual field from the hypernetwork) with
hierarchical NeuS, and adds the silhouette BCE and the eikonal loss; with
``photometric_weight > 0``, in the residual phase, on frames with images,
also the multi-view photometric loss of sphere-traced surfels
(``pipeline/photometric.py``, the sphere-trace kernel on the card).

The field is evaluated by the kernels of ``rendering/field_kernels.py``
(K1/K2 for the fine pass, K3 for the box-only coarse pass); on CPU
tensors they run their plain twins. The loop runs in Python: the step
index, the phase and the metric cadence are host integers, and the
per-step scalars are copied to the host once per chunk. A step never
waits on the device: its constants are made once per device
(``geometry.device_constant``), its per-step numbers (the annealing's
step, Adam's count-dependent scalars) come in as a device vector that
the host fills once per chunk (``chunk_scalars``), and the cumulative
product's backward reads nothing back. So on a card ``optimize_chunk``
replays the step from a CUDA graph (``step_graph``), one launch for the
step's 1,100-1,200. Eagerly (``train_step``) each step is a ``vsrd.step``
span under ``torch.profiler``, cut into the stages of ``utils/spans.py``
(boxes, rays, render, backward, adam, report); a replay is one
``vsrd.step`` span around the graph's launch. With no profiler the spans
cost a flag check each.

Co-optimized frame batches (``optimize_frames_batched``): a FrameData with
a leading frame axis (``sharded.stack_frames``) and params and Adam
moments with the same leading axis run through the same functions. Every
op takes the frame axis as a batch dimension, so a step makes the
launches of one frame whatever F is, and the field goes through ONE launch
of each kernel with a frame grid axis (K4a/K4c/K4b). The per-frame losses
come back as ``[F]`` and are summed for the gradient; frames share the
step's random stream and the Adam step count, as in the JAX package.

Ray-sharded steps (``sp_group``, a ``torch.distributed`` process group of
the processes that share one set of frames; ``pipeline/sharded.py`` makes
them): each process renders its contiguous slice of the step's rays, the
silhouette and eikonal means sum their numerators and denominators over
the group with a differentiable all-reduce, the photometric loss is
averaged over it, and the gradients are averaged over it before Adam, so
that every process takes the same update as one process with all the rays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math

import numpy as np
import torch
import torch.distributed as dist

from ..models import box_parameters, hyper_field
from ..ops import geometry, iou2d, iou3d, matching, sampling
from ..parallel.distributed import all_reduce_sum
from ..rendering import field_kernels, renderer, scene
from ..utils.spans import STEP, span
from . import photometric, step_graph
from .frame import FrameData, ray_directions_at


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Hyperparameters, with the JAX package's fields and defaults.

    The ``kernel_*`` knobs are the ``pallas_*`` knobs of the JAX package
    with the same meaning. ``kernel_matmul_precision`` is
    ``pallas_matmul_precision``: at "default" every layer product of the
    field kernels (K1-K4c, and their twins on CPU tensors) rounds both
    operands to bf16 and sums the exact products in f32, as the TPU's MXU
    at ``Precision.DEFAULT``; at "highest" they are f32 (3xTF32 on the
    card) and the directional coarse pass is off. JAX fields without a
    counterpart here:

    * ``use_pallas``, ``field_dtype`` and ``remat_fields``: they choose
      and configure the XLA field path. The port has no such path; its
      field always goes through the kernels (their plain twins on CPU
      tensors), as the JAX package's kernel path does.
    * ``pallas_rev_grad``: K1 always computes grad_x u by the JAX
      kernel's default ``rev_grad`` form, one reverse sweep per instance.
      The JAX package's other form, three forward tangents (its strict
      mode, and its skip mode), is not ported: at "highest" the reverse
      form computes the same function in f32; in the default mode with
      the skip on its bf16 rounding differs from the three tangents'.
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
    # the photometric branch runs when > 0 in the residual phase on frames
    # with gray_images (every shipped config sets 0.0)
    photometric_weight: float = 0.0
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
    # 'default': the field kernels' layer products take bf16 operands
    # (rounded to nearest even) with f32 sums, as the JAX kernels' MXU
    # products at Precision.DEFAULT; 'highest': f32 products (3xTF32) and
    # the strict parity mode, which also turns the directional coarse pass
    # off. The photometric sphere tracer and render_image stay f32.
    kernel_matmul_precision: str = "default"
    # coarse pass through K3's single directional tangent instead of the
    # full spatial gradient (off in strict mode)
    kernel_dir_coarse: bool = True
    # coarse pass on the box SDF union only (no residual MLP): the residual
    # is non-negative, so the true surface lies inside the box isosurface
    # and the fine pass corrects the placement (same gating as above)
    kernel_box_coarse: bool = True
    # per-tile instance-group skipping for scenes with more than 8 instances
    # (off by default, as in the JAX package): instances sorted by azimuth
    # into groups of 8 and rays by azimuth, each field call with a keep mask
    # per (group, tile of field_kernels.MASK_TILE points); dropped terms are
    # O(e^-12) in the softmin weights (fused_field.group_tile_mask)
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

    The count's scalars (``step_scalars``) are f32 numbers made on the
    host, in the JAX optimizer's order of operations, and enter the update
    as a device tensor (``scalars_from``), so that a CUDA graph of the step replays with each
    step's own: per group the decayed step size -lr decay^count and the
    reciprocals of the two bias corrections (the update multiplies by
    them, as a card divides a tensor by a host number).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8
    NUM_SCALARS = 9     # (step size, 1 / bias correction 1, 1 / bias correction 2) x 3 groups

    def __init__(self, cfg: OptimizationConfig):
        self.cfg = cfg
        self._given = None

    def _group(self, path):
        """Index of a parameter path's group: boxes, embeddings, hypernetwork."""
        if path[0] == "hyper":
            return 2
        if path[1] == "embeddings":
            return 1
        return 0

    def step_scalars(self, count: int) -> np.ndarray:
        """The ``NUM_SCALARS`` f32 scalars of the update at ``count``."""
        f32 = np.float32
        c = f32(count)
        decay = f32(self.cfg.lr_decay) ** c
        b1, b2 = f32(self.b1), f32(self.b2)
        warmup = f32(self.cfg.warmup_steps)
        out = []
        for lr, offset in ((self.cfg.box_lr, f32(0.0)), (self.cfg.embedding_lr, warmup),
                           (self.cfg.hypernetwork_lr, warmup)):
            t = max(c + f32(1.0) - offset, f32(1.0))
            out += [f32(-lr) * decay, f32(1.0) / (f32(1.0) - b1 ** t),
                    f32(1.0) / (f32(1.0) - b2 ** t)]
        return np.asarray(out, np.float32)

    def init(self, params):
        zeros = lambda t: torch.zeros_like(t)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "count": 0}

    @contextlib.contextmanager
    def scalars_from(self, scalars: torch.Tensor):
        """Inside the block ``step`` takes its count's scalars from
        ``scalars`` (``step_scalars(state["count"])`` on the parameters'
        device) instead of making them."""
        self._given = scalars
        try:
            yield
        finally:
            self._given = None

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` and ``state`` in place from ``grads`` (a list
        aligned with ``tree_leaves(params)``; ``None`` counts as zero)."""
        leaves = list(tree_leaves(params))
        scalars = self._given
        if scalars is None:
            scalars = torch.from_numpy(self.step_scalars(state["count"])).to(leaves[0][1].device)
        scalars = scalars.unbind()
        mus = [t for _, t in tree_leaves(state["mu"])]
        nus = [t for _, t in tree_leaves(state["nu"])]
        for (path, p), g, m, v in zip(leaves, grads, mus, nus):
            step_size, inv_bias1, inv_bias2 = scalars[3 * self._group(path):][:3]
            m.mul_(self.b1)
            v.mul_(self.b2)
            if g is not None:
                m.add_(g, alpha=1.0 - self.b1)
                v.addcmul_(g, g, value=1.0 - self.b2)
            m_hat = m * inv_bias1
            v_hat = v * inv_bias2
            p.add_(step_size * m_hat / (torch.sqrt(v_hat) + self.eps))
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


def _masked_mean(values, mask, dim, epsilon=1e-12, group=None):
    """Mean of ``values`` where ``mask`` holds, over ``dim``; with ``group``
    the numerator and the denominator are summed over the group's
    processes first (``jax.lax.psum`` in the JAX package), the numerator
    differentiably."""
    mask = torch.broadcast_to(mask, values.shape).to(values.dtype)
    num = torch.sum(values * mask, dim=dim)
    den = torch.sum(mask, dim=dim)
    if group is not None:
        num = all_reduce_sum(num, group)
        den = all_reduce_sum(den, group)
    return num / torch.clamp(den, min=epsilon)


def _binary_cross_entropy(probs, targets, epsilon=1e-6):
    probs = torch.clamp(probs, epsilon, 1.0 - epsilon)
    return -(targets * torch.log(probs) + (1.0 - targets) * torch.log1p(-probs))


def instance_order(locations, valid):
    """The skip mode's instance order ``[(F,) N]``: by azimuth ``atan2(x,
    z)``, invalid instances last, ties (the invalid slots) in index order,
    as the JAX package's stable ``argsort`` orders them."""
    azimuth = torch.atan2(locations[..., 0], locations[..., 2]).detach()
    return torch.argsort(torch.where(valid, azimuth, 1e9), dim=-1, stable=True)


def ray_order(directions):
    """The skip mode's ray order ``[(F,) R]``: by azimuth of the direction
    (stable), so that a tile of consecutive samples looks one way."""
    azimuth = torch.atan2(directions[..., 0], directions[..., 2])
    return torch.argsort(azimuth, dim=-1, stable=True)


def fold_seed(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed`` (``jax.random.fold_in``'s
    role): a 31-bit hash of the pair, small enough for ``step_generator``."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little") >> 1


def sp_ray_slice(ray_idx, generator, group):
    """This process's contiguous slice of ``ray_idx [(F,) R]``, ``R // S``
    rays for a group of S (the last ``R % S`` rays are dropped, as the JAX
    package's ``dynamic_slice`` drops them), and the render's generator for
    this process: the step's stream folded with the rank in the group, so
    that the processes draw different samples for different rays."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    local = ray_idx.shape[-1] // size
    ray_idx = ray_idx[..., rank * local:(rank + 1) * local]
    if generator is not None:
        generator = torch.Generator(device=generator.device).manual_seed(
            fold_seed(generator.initial_seed(), rank))
    return ray_idx, generator


def compute_loss(params, frame: FrameData, step: int | torch.Tensor, cfg: OptimizationConfig,
                 use_rdf: bool, generator: torch.Generator | None = None,
                 ray_indices: torch.Tensor | None = None,
                 surface_indices: torch.Tensor | None = None,
                 sp_group=None):
    """One forward pass: projection + silhouette (+ eikonal) losses.

    ``step`` is the step index, or a float32 0-d tensor of it on the
    frame's device (the annealing reads it there without a copy from the
    host). ``use_rdf`` selects the post-warmup phase (residual field +
    eikonal).
    ``ray_indices [(F,) R]`` overrides the per-step ray draw with flat
    (view, y, x) pixel indices, so that two implementations can render
    identical rays; ``surface_indices [(F,) R]`` likewise overrides the
    photometric branch's draw of target-view pixels (``y * W + x``), which
    otherwise comes from ``generator`` after the render's draws. Returns
    ``(total, aux)``.

    Stacked frames (a leading frame axis on ``frame`` and ``params``) give
    a per-frame ``total [F]``: every reduction keeps the frame axis, and
    each frame's params only reach its own loss.

    With ``cfg.kernel_group_skip`` and more than 8 instances, the field
    calls see the instances in ``instance_order`` (per frame) and the
    renderer the rays in ``ray_order``; each field call builds one keep
    mask on the device (``field_kernels.group_mask_for``, shared by K1 and
    K2), and the weights come back in the original instance order. The
    projection losses, the photometric branch and the metrics keep the
    original order.

    With ``sp_group`` (see the module docstring) the ray draw, made alike
    on every process of the group from ``generator``, is cut to this
    process's slice (``sp_ray_slice``; group skip's ``ray_order`` then sorts
    the slice), the render and the photometric branch draw from the
    process's own stream, and every loss comes back the same on every
    process of the group. The eikonal mean is then a masked mean with an
    all-ones mask summed over the group; with one process it stays
    ``torch.mean``, so the single-process numbers do not move.
    """
    n = frame.max_instances
    device = frame.device
    lead = frame.valid.shape[:-1]      # (F,) for stacked frames, () for one

    def frame_mean(values, mask):
        """Masked mean over every axis but the leading frame axis."""
        return _masked_mean(values, mask, dim=tuple(range(len(lead), values.ndim)))

    # ---------------- projection + matching ----------------
    with span("vsrd.boxes"):
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
        cam_corners_target = _at_target(cam_corners, frame)

    with span("vsrd.rays"):
        # ---------------- annealing (f32, as in the JAX package) ----------------
        if not isinstance(step, torch.Tensor):
            step = torch.tensor(step, dtype=torch.float32, device=device)
        progress = step / cfg.num_steps
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
        scale = cfg.position_scale
        # the field's inputs: in instance_order with the skip mode
        group_skip = cfg.kernel_group_skip and n > 8
        field_in = (locations, rotations, half_dims, frame.valid, field_weights)
        if group_skip:
            perm = instance_order(locations, frame.valid)
            inv_perm = torch.argsort(perm, dim=-1)

            def gather(t):
                index = perm.reshape(*perm.shape, *([1] * (t.ndim - perm.ndim)))
                return torch.take_along_dim(t, index, dim=len(lead))

            field_in = tuple(None if t is None else gather(t) for t in field_in)
        loc_f, rot_f, half_f, valid_b, weights_f = field_in
        valid_f = valid_b.to(torch.float32)

        def field_call(kernel, positions, *extra, weights):
            """One field call on ``[(F,) R, S, 3]`` positions as ``[(F,) R * S,
            3]``, with its keep mask in the skip mode; the weights come back in
            the original instance order."""
            shape = positions.shape[:-1]
            flat = positions.reshape(*lead, -1, 3)
            mask = (field_kernels.group_mask_for(flat, loc_f, half_f, valid_f, temperature)
                    if group_skip else None)
            u, w, x = kernel(flat, *(e.reshape(*lead, -1, 3) for e in extra), loc_f, rot_f,
                             half_f, valid_f, weights, temperature, scale, mask, precision)
            if group_skip:
                w = torch.take_along_dim(w, inv_perm[..., None, :].expand(w.shape), dim=-1)
            return (u.reshape(shape), w.reshape(*shape, n),
                    x.reshape(*shape, *x.shape[len(lead) + 1:]))

        precision = cfg.kernel_matmul_precision

        def field_with_grad(positions):
            return field_call(field_kernels.fused_field_with_grad, positions, weights=weights_f)

        field_with_dirgrad_coarse = None
        if cfg.kernel_dir_coarse and cfg.kernel_matmul_precision != "highest":
            coarse_weights = None if (cfg.kernel_box_coarse and use_rdf) else weights_f

            def field_with_dirgrad_coarse(positions, directions):
                weights = None if coarse_weights is None else coarse_weights.detach()
                return field_call(field_kernels.fused_field_dir_forward, positions, directions,
                                  weights=weights)

        # ---------------- silhouette rendering ----------------
        if ray_indices is None:
            cand_idx = sampling.multinomial_logits(
                frame.candidate_weights, cfg.num_rays, generator=generator)
            ray_idx = torch.take_along_dim(frame.candidate_indices, cand_idx, dim=-1)
        else:
            ray_idx = ray_indices.long()
        render_generator = generator
        if sp_group is not None:
            ray_idx, render_generator = sp_ray_slice(ray_idx, generator, sp_group)
        origins, directions = ray_directions_at(frame, ray_idx)
        if group_skip:
            # targets follow ray_idx, and every ray reduction is a mean
            order = ray_order(directions)
            ray_idx = torch.take_along_dim(ray_idx, order, dim=-1)
            origins = torch.take_along_dim(origins, order[..., None], dim=-2)
            directions = torch.take_along_dim(directions, order[..., None], dim=-2)

    with span("vsrd.render"):
        out = renderer.hierarchical_render(
            origins, directions, cfg.distance_range, cfg.num_samples, std, cosine_ratio,
            field_with_grad=field_with_grad,
            field_with_dirgrad_coarse=field_with_dirgrad_coarse,
            deterministic=cfg.deterministic, generator=render_generator,
        )
        rendered = out.features  # [(F,) R, N] per-ray instance probabilities

        targets = torch.take_along_dim(frame.soft_masks_flat, ray_idx[..., None], dim=-2)
        targets = torch.take_along_dim(targets.to(rendered.dtype), row_to_col[..., None, :], dim=-1)
        bce = _binary_cross_entropy(rendered, targets)
        silhouette_loss = _masked_mean(bce, frame.valid[..., None, :], dim=(-2, -1), group=sp_group)

        losses = {
            "iou_projection_loss": iou_loss,
            "l1_projection_loss": l1_loss,
            "silhouette_loss": silhouette_loss,
        }
        zero = torch.zeros(lead, device=device)
        if use_rdf:
            norms = torch.linalg.vector_norm(out.gradients, dim=-1)
            squares = torch.square(norms - 1.0)
            if sp_group is None:
                losses["eikonal_loss"] = torch.mean(squares, dim=(-2, -1))
            else:
                losses["eikonal_loss"] = _masked_mean(squares, torch.ones_like(squares),
                                                      dim=(-2, -1), group=sp_group)
        else:
            losses["eikonal_loss"] = zero
        if cfg.photometric_weight > 0.0 and use_rdf and frame.gray_images is not None:
            hard = scene.SceneParams(locations, rotations, half_dims, frame.valid, field_weights)
            losses["photometric_loss"], _ = photometric.photometric_loss(
                frame, hard, render_generator,
                num_rays=cfg.surface_num_rays,
                num_iterations=cfg.surface_num_iterations,
                convergence_criteria=cfg.surface_convergence_criteria,
                bounding_radius=cfg.surface_bounding_radius,
                patch_size=cfg.surface_patch_size,
                local_idx=surface_indices,
                position_scale=scale,
            )
            if sp_group is not None:
                # each process draws its own surface rays: the average over the
                # group (pmean in the JAX package) is the reported value
                losses["photometric_loss"] = (all_reduce_sum(losses["photometric_loss"], sp_group)
                                              / dist.get_world_size(sp_group))
        else:
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
        "cam_corners_target": cam_corners_target,
        "temperature": temperature,
        "sdf_std_deviation": std,
    }
    return total, aux


METRIC_NAMES = ("iou_3d", "iou_bev", "accuracy_3d_25", "accuracy_bev_25",
                "accuracy_3d_50", "accuracy_bev_50", "num_matched")
# a step's scalars, in the order train_step returns them
SCALAR_NAMES = ("loss", "iou_projection_loss", "l1_projection_loss", "silhouette_loss",
                "eikonal_loss", "photometric_loss", *METRIC_NAMES, "temperature",
                "sdf_std_deviation")


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


def sp_mean_gradients(grads, group):
    """Average gradients over ``group`` (one all-reduce of them all
    flattened; ``None`` stays ``None``, alike on every process). Through
    ``compute_loss``'s differentiable sums a ray-local term hands each
    process S times its own rays' share and a replicated term its whole
    gradient, so the average is the single-process gradient of both, as
    the JAX package's ``pmean`` of the gradients is."""
    present = [g for g in grads if g is not None]
    if not present:
        return grads
    flat = torch.cat([g.reshape(-1) for g in present])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    pieces = iter(torch.split(flat, [g.numel() for g in present]))
    return [None if g is None else next(pieces).view_as(g) for g in grads]


def chunk_scalars(cfg: OptimizationConfig, optimizer: Adam, start_step: int, count: int,
                  num_steps: int, device) -> torch.Tensor:
    """The per-step numbers of ``num_steps`` steps from ``start_step`` and
    the Adam count ``count``, made on the host and sent to ``device`` in one
    copy that does not wait on it: ``[steps, 1 + Adam.NUM_SCALARS]`` f32,
    each row the step index (the annealing's input) and
    ``optimizer.step_scalars`` at the step's count."""
    rows = np.empty((num_steps, 1 + Adam.NUM_SCALARS), np.float32)
    for i in range(num_steps):
        rows[i, 0] = start_step + i
        rows[i, 1:] = optimizer.step_scalars(count + i)
    table = torch.from_numpy(rows)
    if torch.device(device).type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table.to(device)


def _update(params, opt_state, frame: FrameData, step: torch.Tensor, adam_scalars: torch.Tensor,
            cfg: OptimizationConfig, optimizer: Adam, use_rdf: bool, generator=None,
            ray_indices=None, sp_group=None):
    """The step up to its report: the loss, its gradients and Adam's update
    of ``params`` and ``opt_state`` in place, with the step's numbers from a
    row of ``chunk_scalars``: ``step`` (its first entry) and
    ``adam_scalars`` (the rest). Returns ``(total, aux)``."""
    leaves = [t for _, t in tree_leaves(params)]
    with span("vsrd.backward"):
        for leaf in leaves:
            leaf.requires_grad_(True)
    total, aux = compute_loss(params, frame, step, cfg, use_rdf, generator, ray_indices,
                              sp_group=sp_group)
    with span("vsrd.backward"):
        grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        if sp_group is not None:
            grads = sp_mean_gradients(grads, sp_group)
    with span("vsrd.adam"), optimizer.scalars_from(adam_scalars):
        optimizer.step(params, grads, opt_state)
    return total, aux


def _report(total, aux, metrics, lead) -> dict:
    """The step's scalars in ``SCALAR_NAMES`` order (the metrics 0 off a
    metric step)."""
    if metrics is None:
        zero = torch.zeros(lead, device=total.device)
        metrics = {name: zero for name in METRIC_NAMES}
    return {
        "loss": total.detach(),
        **{k: v.detach() for k, v in aux["losses"].items()},
        **metrics,
        "temperature": aux["temperature"].expand(lead),
        "sdf_std_deviation": aux["sdf_std_deviation"].expand(lead),
    }


def is_metric_step(step: int, cfg: OptimizationConfig) -> bool:
    return (step + 1) % cfg.metric_interval == 0


def train_step(params, opt_state, frame: FrameData, step: int, cfg: OptimizationConfig,
               optimizer: Adam, generator: torch.Generator | None = None,
               ray_indices: torch.Tensor | None = None, sp_group=None,
               scalars: torch.Tensor | None = None):
    """One eager optimization step with the warmup phase switch; updates
    ``params`` and ``opt_state`` in place and returns the step's scalars
    as device tensors (0-d, or ``[F]`` for stacked frames, whose per-frame
    losses are summed for the gradient). With ``sp_group`` the rays are
    sharded over the group (``compute_loss``) and the gradients averaged
    over it (``sp_mean_gradients``) before the update. ``scalars``: the
    step's row of ``chunk_scalars`` (made here, with a copy that waits on
    the device, when not given). Counts in ``step_graph.graphs.eager_steps``."""
    step_graph.graphs.eager_steps += 1
    if scalars is None:
        scalars = chunk_scalars(cfg, optimizer, step, opt_state["count"], 1, frame.device)[0]
    step_value, adam_scalars = scalars[0], scalars[1:]
    with span(STEP):
        total, aux = _update(params, opt_state, frame, step_value, adam_scalars, cfg, optimizer,
                             step >= cfg.warmup_steps, generator, ray_indices, sp_group)
        with span("vsrd.report"):
            metrics = None
            if is_metric_step(step, cfg):
                metrics = compute_metrics(frame, aux["cam_corners_target"].detach(),
                                          aux["row_to_col"])
            return _report(total, aux, metrics, frame.valid.shape[:-1])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The per-step random stream: a pure function of (seed, step), so that
    a run resumed at step k continues the same stream."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def step_seed(seed: int, step: int) -> int:
    return seed * 1_000_003 + step


def _state_leaves(params, opt_state) -> list:
    """The tensors a step updates: the parameters, then both moments."""
    return [t for tree in (params, opt_state["mu"], opt_state["nu"])
            for _, t in tree_leaves(tree)]


def _graph_key(params, frame: FrameData, cfg: OptimizationConfig, use_rdf: bool):
    """What the step's code can observe beside the frame (the phase, the
    device, the config, the parameters' shapes and dtypes, the skip mask's
    tile), or ``None`` where the step runs eagerly: CPU tensors and the
    photometric branch (its march reads trip counts back)."""
    if frame.device.type != "cuda" or (cfg.photometric_weight > 0.0 and use_rdf
                                       and frame.gray_images is not None):
        return None
    leaves = tuple((path, tuple(t.shape), t.dtype) for path, t in tree_leaves(params))
    return use_rdf, frame.device, cfg, leaves, field_kernels.MASK_TILE


def _capture(entry, params, opt_state, frame: FrameData, cfg: OptimizationConfig, optimizer,
             use_rdf: bool, scalars: torch.Tensor):
    """Capture the key's step on copies of ``params`` and ``opt_state``:
    the graph's outputs are the step's scalars (``SCALAR_NAMES`` stacked,
    the metrics 0) and the inputs of ``compute_metrics``."""
    lead = frame.valid.shape[:-1]
    static_params = tree_map(torch.clone, params)
    static_state = {"mu": tree_map(torch.clone, opt_state["mu"]),
                    "nu": tree_map(torch.clone, opt_state["nu"]), "count": opt_state["count"]}

    def step(step_scalars, generator):
        with span(STEP):
            total, aux = _update(static_params, static_state, frame, step_scalars[0],
                                 step_scalars[1:], cfg, optimizer, use_rdf, generator)
            with span("vsrd.report"):
                values = _report(total, aux, None, lead)
                return (torch.stack([values[name] for name in SCALAR_NAMES]),
                        aux["cam_corners_target"].detach(), aux["row_to_col"])

    entry.capture(step, _state_leaves(static_params, static_state), scalars, frame.device)


def optimize_chunk(params, opt_state, frame: FrameData, seed: int, start_step: int,
                   cfg: OptimizationConfig, num_steps: int, optimizer: Adam | None = None):
    """Run ``num_steps`` steps from ``start_step``; returns the per-step
    scalars stacked (``[steps]``, or ``[steps, F]`` for stacked frames) and
    copied to the host once.

    On a card each step replays its key's CUDA graph (``step_graph``): the
    key's first step runs eagerly on the capture stream, its second is
    captured and replayed, and a metric step replays and then runs
    ``compute_metrics`` on the graph's outputs. The parameters and moments
    are copied into a graph's buffers before its first replay in a run of
    its replays and back out after it. ``_graph_key`` says which steps stay
    eager (all of them on the CPU)."""
    optimizer = optimizer or Adam(cfg)
    device = frame.device
    lead = frame.valid.shape[:-1]
    table = chunk_scalars(cfg, optimizer, start_step, opt_state["count"], num_steps,
                          device).unbind()
    out = torch.empty(num_steps, len(SCALAR_NAMES), *lead, device=device)
    keys = {use_rdf: _graph_key(params, frame, cfg, use_rdf)
            for use_rdf in {s >= cfg.warmup_steps for s in range(start_step,
                                                                 start_step + num_steps)}}
    leaves = _state_leaves(params, opt_state)
    metrics = slice(SCALAR_NAMES.index(METRIC_NAMES[0]),
                    SCALAR_NAMES.index(METRIC_NAMES[-1]) + 1)
    bound = None     # the graph whose buffers hold the state
    try:
        for i, step in enumerate(range(start_step, start_step + num_steps)):
            use_rdf = step >= cfg.warmup_steps
            key = keys[use_rdf]
            entry = None if key is None else step_graph.graphs.entry(key, frame)
            if bound is not None and entry is not bound:
                bound.store(leaves)
                bound = None
            if entry is not None and entry.warm and entry.graph is None:
                _capture(entry, params, opt_state, frame, cfg, optimizer, use_rdf, table[i])
            if entry is None or entry.graph is None:
                stream = (contextlib.nullcontext() if entry is None
                          else step_graph.on_capture_stream(device))
                with stream:
                    scalars = train_step(params, opt_state, frame, step, cfg, optimizer,
                                         step_generator(seed, step, device), scalars=table[i])
                    out[i].copy_(torch.stack([scalars[name] for name in SCALAR_NAMES]))
                if entry is not None:
                    entry.warm = True
                continue
            if bound is None:
                entry.load(leaves)
                bound = entry
            with span(STEP):
                entry.replay(table[i], step_seed(seed, step))
                opt_state["count"] += 1
                packed, cam_corners_target, row_to_col = entry.outputs
                out[i].copy_(packed)
                if is_metric_step(step, cfg):
                    with span("vsrd.report"):
                        values = compute_metrics(frame, cam_corners_target, row_to_col)
                        out[i, metrics].copy_(torch.stack([values[n] for n in METRIC_NAMES]))
    finally:
        if bound is not None:
            bound.store(leaves)
    with span("vsrd.report"):
        host = out.cpu().numpy()
    return {name: np.ascontiguousarray(host[:, j]) for j, name in enumerate(SCALAR_NAMES)}


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
