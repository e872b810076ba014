"""The plain reference of one auto-labeling step, in PyTorch and float32.

What VSRD's per-frame optimization computes in a step, written from its
description and independent of the port (this module imports nothing of
``vsrd_tpu_torch``): decode every instance's box, project it into every view,
match the target view's boxes to the ground truth (scipy's Hungarian solver),
the DIoU and smooth-L1 projection losses, Gumbel-top-k rays over the frame's
candidate pixels, hierarchical NeuS along them through the softmin union of
the box distance fields (after warmup plus each instance's residual MLP, whose
weights the hypernetwork makes from its embedding), the silhouette BCE and
the eikonal loss; the gradients by autograd (the spatial gradient with
``create_graph``), then Adam with its per-group rates, decay and the
warmup offset of the embeddings' and the hypernetwork's bias correction.

Matrix products run in float32 with TF32 off. ``products`` (see
``lower_precision``) rounds both operands of every layer product of the
residual MLP to a lower dtype, each tensor scaled onto the type's range
first, forward and backward, with the sums in float32: with float8 that is
the control, the reference in the precision below the configuration's, as
an fp8 kernel with per-tensor scales would run it.

``field_at`` evaluates the scene field (the union, its weights and its
spatial gradient) at given points, and the cotangent of the residual MLP's
weights for given cotangents of those outputs: the check of the field
kernels' own outputs at the points where the program evaluated them.

The random draws of a step (the Gumbel noise of the ray draw, the coarse
pass's stratified jitter, the fine pass's uniforms) come from a CUDA or CPU
``torch.Generator`` seeded with the step's stream seed, in that order and
with the shapes the step draws them in, so that both sides render the same
rays at the same jitter.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

LOCATION_RANGE = ((-50.0, 1.55 - 1.75 / 2.0 - 5.0, 0.0), (50.0, 1.55 - 1.75 / 2.0 + 5.0, 100.0))
DIMENSION_RANGE = ((0.75, 0.75, 1.5), (1.0, 1.0, 2.5))
UNIT_CORNERS = (
    (-1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, -1.0, -1.0),
    (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (1.0, 1.0, -1.0), (-1.0, 1.0, -1.0),
)
EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7))
FIELD_IN, FIELD_HIDDEN, FREQUENCIES = 48, (16, 16, 16, 16), 8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------- products

def round_to(x, dtype):
    """``x`` rounded to ``dtype`` and back, scaled first so that its largest
    magnitude lands on the type's largest value, as a float8 product with
    per-tensor scales is run."""
    scale = torch.finfo(dtype).max / torch.clamp(x.detach().abs().amax(), min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def lower_precision(dtype):
    """The rounding of a lower-precision product's operands (``products``)."""
    return functools.partial(round_to, dtype=dtype)


class _LowMatmul(torch.autograd.Function):
    """``round(a) @ round(b)`` with f32 sums; its backward rounds the same
    way and is itself differentiable (the eikonal term differentiates the
    field's spatial gradient)."""

    @staticmethod
    def forward(ctx, a, b, rounding):
        ctx.save_for_backward(a, b)
        ctx.rounding = rounding
        return rounding(a) @ rounding(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return (_LowMatmul.apply(grad, b.mT, ctx.rounding),
                _LowMatmul.apply(a.mT, grad, ctx.rounding), None)


def matmul(a, b, products):
    return a @ b if products is None else _LowMatmul.apply(a, b, products)


# ---------------------------------------------------------------- boxes

def decode(boxes):
    """Box parameters -> (corners [N, 8, 3], locations, half sizes, R [N, 3, 3])."""
    lo, hi = (torch.tensor(r, device=boxes["locations"].device) for r in LOCATION_RANGE)
    loc = lo + (hi - lo) * torch.sigmoid(boxes["locations"])
    dlo, dhi = (torch.tensor(r, device=loc.device) for r in DIMENSION_RANGE)
    half = dlo + (dhi - dlo) * torch.sigmoid(boxes["dimensions"])
    o = boxes["orientations"]
    unit = o / torch.clamp(torch.linalg.vector_norm(o, dim=-1, keepdim=True), min=1e-12)
    c, s = unit[..., 0], unit[..., 1]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, zero, s], -1), torch.stack([zero, one, zero], -1),
                       torch.stack([-s, zero, c], -1)], -2)
    corners = torch.tensor(UNIT_CORNERS, device=loc.device) * half[:, None, :]
    corners = corners @ rot.transpose(-2, -1) + loc[:, None, :]
    return corners, loc, half, rot


def project(corners, intrinsics, extrinsics, image_size, epsilon=1e-6):
    """World corners [N, 8, 3] -> 2D boxes [V, N, 4] (x0, y0, x1, y1) in every
    view: the box's edges clipped to the front of the camera, projected,
    their extent clamped to the image; a box wholly behind reads zeros."""
    h, w = image_size
    homo = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    cam = torch.einsum("vij,nkj->vnki", extrinsics, homo)
    cam = cam[..., :3] / cam[..., 3:]                                    # [V, N, 8, 3]
    edges = cam[..., torch.tensor(EDGES, device=cam.device), :]         # [V, N, 12, 2, 3]
    a, b = edges[..., 0, :], edges[..., 1, :]
    a_front = a[..., 2:] > b[..., 2:]
    far = torch.where(a_front, a, b)
    near = torch.where(a_front, b, a)
    t = torch.clamp(far[..., 2:] / torch.clamp(far[..., 2:] - near[..., 2:], min=epsilon),
                    max=1.0)
    near = far + (near - far) * t
    front = far[..., 2] > 0                                              # [V, N, 12]
    ends = torch.stack([far, near], -2)                                  # [V, N, 12, 2, 3]
    pix = torch.einsum("vij,vnlej->vnlei", intrinsics, ends)
    pix = pix[..., :2] / torch.clamp(pix[..., 2:], min=epsilon)
    big = torch.finfo(pix.dtype).max
    keep = front[..., None, None]
    mins = torch.where(keep, pix, big).amin((-3, -2))
    maxs = torch.where(keep, pix, -big).amax((-3, -2))
    seen = front.any(-1)[..., None]
    mins = torch.where(seen, mins, 0.0)
    maxs = torch.where(seen, maxs, 0.0)
    limit = torch.tensor([w, h], dtype=pix.dtype, device=pix.device)
    return torch.cat([torch.minimum(mins.clamp(min=0.0), limit),
                      torch.minimum(maxs.clamp(min=0.0), limit)], -1)


def diou(b1, b2, epsilon=1e-7):
    """Distance IoU of (x0, y0, x1, y1) box pairs that broadcast together."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    wh = torch.clamp(torch.minimum(b1[..., 2:], b2[..., 2:])
                     - torch.maximum(b1[..., :2], b2[..., :2]), min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area1 + area2 - inter + epsilon)
    diag = torch.sum(torch.square(torch.maximum(b1[..., 2:], b2[..., 2:])
                                  - torch.minimum(b1[..., :2], b2[..., :2])), -1) + epsilon
    dist = torch.sum(torch.square((b1[..., :2] + b1[..., 2:]) / 2
                                  - (b2[..., :2] + b2[..., 2:]) / 2), -1)
    return iou - dist / diag


# ---------------------------------------------------------------- field

def hypernetwork(hyper, embeddings):
    """Embeddings [N, 256] -> flat field-MLP weights [N, 1617]: weight-normed
    linear layers with LayerNorm and exact GELU between them."""
    x = embeddings
    layers = hyper["layers"]
    for index, layer in enumerate(layers):
        v = layer["v"]
        weight = v * (layer["g"][:, None] / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
        x = x @ weight.T + layer["b"]
        if index < len(layers) - 1:
            x = F.layer_norm(x, x.shape[-1:], eps=1e-5) * layer["ln_scale"] + layer["ln_bias"]
            x = F.gelu(x)
    return x


def mlp_blocks(flat):
    """Flat weights [N, 1617] -> per layer [N, out, in + 1], bias last."""
    ins = (FIELD_IN, *FIELD_HIDDEN)
    outs = (*FIELD_HIDDEN, 1)
    blocks, start = [], 0
    for c_in, c_out in zip(ins, outs):
        count = c_out * (c_in + 1)
        blocks.append(flat[:, start:start + count].reshape(-1, c_out, c_in + 1))
        start += count
    return blocks


def encode(local, scale):
    """(|x|, y, z) / scale -> [cos, sin](pi 2^k .) for k < 8, channels in
    (dim, k, cos/sin) order: [..., 48]."""
    sym = torch.cat([torch.abs(local[..., :1]), local[..., 1:]], -1) / scale
    freq = (2.0 ** torch.arange(FREQUENCIES, device=local.device, dtype=local.dtype)) * math.pi
    phase = sym[..., :, None] * freq                                   # [..., 3, k]
    return torch.stack([torch.cos(phase), torch.sin(phase)], -1).flatten(-3)


def instance_distances(points, loc, rot, half, blocks, scale, products):
    """Signed distance of each instance [P, N] at points [P, 3]: the box's,
    plus sigmoid(mlp - 1) of the instance's residual field when ``blocks``."""
    local = torch.einsum("pnk,nkj->pnj", points[:, None, :] - loc[None], rot)
    q = torch.abs(local) - half[None]
    outside = torch.sqrt(torch.sum(F.relu(q) ** 2, -1) + 1e-6)
    inside = F.relu(-torch.amax(q, -1))
    d = outside - inside
    if blocks is None:
        return d
    x = encode(local, scale).transpose(0, 1)                           # [N, P, 48]
    for index, block in enumerate(blocks):
        if index:
            x = F.gelu(F.layer_norm(x, x.shape[-1:], eps=1e-5))
        x = torch.cat([x, torch.ones_like(x[..., :1])], -1)
        x = matmul(x, block.transpose(-2, -1), products)
    return d + torch.sigmoid(x[..., 0].T - 1.0)


def annealed(step, recipe, device):
    """(progress, union temperature, NeuS std) at ``step``: cosine from the
    maximum to the minimum over the run."""
    progress = torch.tensor(step, dtype=torch.float32, device=device) / recipe["num_steps"]

    def anneal(hi, lo):
        return (torch.cos(math.pi * progress) + 1.0) / 2.0 * (hi - lo) + lo

    return progress, anneal(*recipe["temperature"]), anneal(*recipe["std"])


def union(d, valid, temperature):
    """Softmin union over instances: (u [P], weights [P, N])."""
    logits = -d / temperature + (valid.to(d.dtype) - 1.0) * 1e30
    w = torch.softmax(logits, -1)
    return torch.sum(d * w, -1), w


def field_at(params, scene, step, positions, recipe, cotangents=None, products=None):
    """The scene field of ``params`` at ``step`` and at ``positions [P,
    3]``: ``u [P]``, ``w [P, N]`` and ``g [P, 3]`` (the spatial gradient of
    ``u``); with ``cotangents`` (``du``, ``dw``, ``dg`` of those outputs)
    also ``dweights [N, 1617]``, their cotangent of the flat residual-MLP
    weights that the hypernetwork makes."""
    _, loc, half, rot = decode(params["boxes"])
    _, temperature, _ = annealed(step, recipe, loc.device)
    flat = hypernetwork(params["hyper"], params["boxes"]["embeddings"]).detach()
    flat.requires_grad_(cotangents is not None)
    pos = positions.detach().requires_grad_(True)
    d = instance_distances(pos, loc.detach(), rot.detach(), half.detach(), mlp_blocks(flat),
                           max(recipe["distance_range"]), products)
    u, w = union(d, scene["valid"], temperature)
    (g,) = torch.autograd.grad(u.sum(), pos, create_graph=cotangents is not None)
    out = {"u": u.detach(), "w": w.detach(), "g": g.detach()}
    if cotangents is not None:
        (dweights,) = torch.autograd.grad((u, w, g), flat, [cotangents[k]
                                                            for k in ("du", "dw", "dg")])
        out["dweights"] = dweights
    return out


def box_field_at(params, scene, step, positions, recipe):
    """``u``, ``w`` and ``g`` of ``field_at`` for the boxes alone."""
    _, loc, half, rot = decode(params["boxes"])
    _, temperature, _ = annealed(step, recipe, loc.device)
    pos = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        d = instance_distances(pos, loc.detach(), rot.detach(), half.detach(), None,
                               max(recipe["distance_range"]), None)
        u, w = union(d, scene["valid"], temperature)
        (g,) = torch.autograd.grad(u.sum(), pos)
    return {"u": u.detach(), "w": w.detach(), "g": g}


# ---------------------------------------------------------------- render

def neus(sdf, cosines, intervals, std, ratio, epsilon=1e-6):
    eased = F.relu(-cosines * 0.5 + 0.5)
    hard = F.relu(-cosines)
    cosines = -(eased + (hard - eased) * ratio)
    prev_cdf = torch.sigmoid((sdf - cosines * intervals / 2.0) / std)
    next_cdf = torch.sigmoid((sdf + cosines * intervals / 2.0) / std)
    alpha = F.relu((prev_cdf - next_cdf) / (prev_cdf + epsilon))
    trans = torch.cumprod(1.0 - alpha, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return trans * alpha


def importance(bins, weights, uniform):
    """Inverse-CDF samples of the piecewise-constant pdf ``weights [R, S-1]``
    over ``bins [R, S]`` at the sorted ``uniform [R, M]``."""
    pdf = weights / torch.clamp(torch.sum(torch.abs(weights), -1, keepdim=True), min=1e-12)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.minimum(uniform, cdf[..., -1:]).contiguous()
    i = torch.clamp(torch.searchsorted(cdf.contiguous(), u, side="left"), 1, cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, i - 1), torch.gather(cdf, -1, i)
    b0, b1 = torch.gather(bins, -1, i - 1), torch.gather(bins, -1, i)
    t = torch.clamp((u - c0) / (c1 - c0 + 1e-6), 0.0, 1.0)
    return b0 + (b1 - b0) * t


def rays(scene, ray_idx):
    """Origins and unit directions [R, 3] of flat (view, y, x) pixel indices."""
    h, w = scene["image_size"]
    view = ray_idx // (h * w)
    rem = ray_idx % (h * w)
    pix = torch.stack([(rem % w).float(), (rem // w).float(), torch.ones_like(rem).float()], -1)
    # a product and a sum, not a matmul: the box SDF's gradient jumps at its
    # facets, so direction rounding of 1e-7 moves isolated samples
    dirs = torch.sum(scene["inv_projections"][view] * pix[:, None, :], -1)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    return scene["camera_positions"][view], dirs


# ---------------------------------------------------------------- loss

def frame_loss(params, scene, step, draws, recipe, products=None):
    """The loss of one frame at ``step`` with its draws (``gumbel [K]``,
    ``coarse [R, S]``, ``fine [R, S]``)."""
    use_rdf = step >= recipe["warmup_steps"]
    boxes = params["boxes"]
    corners, loc, half, rot = decode(boxes)
    valid = scene["valid"]
    n = valid.shape[0]
    t = scene["target_index"]

    pd = project(corners, scene["intrinsics"], scene["extrinsics"], scene["image_size"])
    gt = scene["gt_boxes_2d"].reshape(-1, n, 4)
    cost = -diou(pd[t][:, None, :], gt[t][None, :, :]).detach()
    # a pair with a padded instance costs more than any real one
    cost = torch.where(valid[:, None] & valid[None, :], cost, 1e6)
    rows, cols = linear_sum_assignment(cost.double().cpu().numpy())
    match = torch.as_tensor(cols[np.argsort(rows)], device=loc.device)  # pred i -> GT
    gt_m = gt[:, match]
    pair = (scene["visible"][:, match] & valid[None]).to(pd.dtype)       # [V, N]
    iou_loss = torch.sum((1.0 - diou(pd, gt_m)) * pair) / torch.clamp(pair.sum(), min=1e-12)
    l1 = F.smooth_l1_loss(pd, gt_m, reduction="none", beta=1.0)
    l1_loss = torch.sum(l1 * pair[..., None]) / torch.clamp(4 * pair.sum(), min=1e-12)

    progress, temperature, std = annealed(step, recipe, loc.device)
    blocks = mlp_blocks(hypernetwork(params["hyper"], boxes["embeddings"])) if use_rdf else None
    scale = max(recipe["distance_range"])

    # rays: the Gumbel top-k of the candidates' log weights
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(draws["gumbel"].clamp(min=tiny)))
    pick = torch.topk(scene["candidate_weights"] + gumbel, recipe["num_rays"]).indices
    ray_idx = scene["candidate_indices"][pick]
    origins, dirs = rays(scene, ray_idx)

    # coarse: the box union, gradient-stopped, its derivative along the ray
    lo, hi = recipe["distance_range"]
    edges = torch.linspace(lo, hi, recipe["num_samples"] + 1, device=loc.device)
    coarse_d = edges[:-1] + (edges[1:] - edges[:-1]) * draws["coarse"]
    with torch.no_grad():
        mid = (coarse_d[:, :-1] + coarse_d[:, 1:]) / 2.0
        pos = (origins[:, None] + dirs[:, None] * mid[..., None]).reshape(-1, 3)
        with torch.enable_grad():
            pos = pos.requires_grad_(True)
            u, _ = union(instance_distances(pos, loc.detach(), rot.detach(), half.detach(),
                                            None, scale, None), valid, temperature.detach())
            (g,) = torch.autograd.grad(u.sum(), pos)
        u_dot = torch.sum(g.reshape(*mid.shape, 3) * dirs[:, None], -1)
        coarse_w = neus(u.reshape(mid.shape), torch.clamp(u_dot, -1.0, 1.0),
                        coarse_d[:, 1:] - coarse_d[:, :-1], std, progress)
        fine = importance(coarse_d, coarse_w, torch.sort(draws["fine"], -1).values)
        dist = torch.sort(torch.cat([coarse_d, fine], -1), -1).values

    # fine: the full field with its spatial gradient, differentiable
    mid = (dist[:, :-1] + dist[:, 1:]) / 2.0
    pos = (origins[:, None] + dirs[:, None] * mid[..., None]).reshape(-1, 3).requires_grad_(True)
    u, w = union(instance_distances(pos, loc, rot, half, blocks, scale, products), valid,
                 temperature)
    (g,) = torch.autograd.grad(u.sum(), pos, create_graph=True)
    u, w, g = u.reshape(mid.shape), w.reshape(*mid.shape, n), g.reshape(*mid.shape, 3)
    normals = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
    cosines = torch.sum(dirs[:, None] * normals, -1)
    weights = neus(u, cosines, dist[:, 1:] - dist[:, :-1], std, progress)
    probs = torch.sum(w * weights[..., None], -2)                        # [R, N]

    targets = scene["soft_masks_flat"][ray_idx].float()[:, match]
    probs = torch.clamp(probs, 1e-6, 1.0 - 1e-6)
    bce = -(targets * torch.log(probs) + (1.0 - targets) * torch.log1p(-probs))
    mask = valid[None].to(bce.dtype).expand(bce.shape)
    silhouette = torch.sum(bce * mask) / torch.clamp(mask.sum(), min=1e-12)
    eikonal = (torch.mean(torch.square(torch.linalg.vector_norm(g, dim=-1) - 1.0))
               if use_rdf else torch.zeros((), device=loc.device))
    weights_of = recipe["loss_weights"]
    return (weights_of["iou_projection"] * iou_loss + weights_of["l1_projection"] * l1_loss
            + weights_of["silhouette"] * silhouette + weights_of["eikonal"] * eikonal)


# ---------------------------------------------------------------- params

def leaves(tree, prefix=()):
    """(path, tensor) pairs of nested dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for index, item in enumerate(tree):
            yield from leaves(item, prefix + (index,))
    else:
        yield prefix, tree


def rebuild(tree, values):
    """``tree``'s structure with its leaves replaced, in ``leaves`` order."""
    values = iter(values)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return next(values)

    return go(tree)


def learning_rate(path, recipe):
    """(rate, bias-correction offset) of a parameter: the embeddings and the
    hypernetwork get no gradient before warmup ends, so their Adam count
    starts there."""
    if path[0] == "hyper":
        return recipe["hypernetwork_lr"], recipe["warmup_steps"]
    if path[-1] == "embeddings":
        return recipe["embedding_lr"], recipe["warmup_steps"]
    return recipe["box_lr"], 0


def adam(params, grads, state, recipe):
    """One Adam update of every leaf (a zero gradient where there is none),
    with the rate decayed by ``lr_decay ** count``; returns new params and
    state."""
    f32 = np.float32
    count = state["count"]
    decay = f32(recipe["lr_decay"]) ** f32(count)
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(leaves(params), grads, state["mu"], state["nu"]):
        rate, offset = learning_rate(path, recipe)
        g = torch.zeros_like(p) if g is None else g
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        t = max(f32(count) + f32(1.0) - f32(offset), f32(1.0))
        m_hat = m / float(f32(1.0) - f32(ADAM_B1) ** t)
        v_hat = v / float(f32(1.0) - f32(ADAM_B2) ** t)
        new_p.append(p - float(f32(rate) * decay) * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        new_m.append(m)
        new_v.append(v)
    return rebuild(params, new_p), {"mu": new_m, "nu": new_v, "count": count + 1}


def adam_init(params, count):
    zeros = [torch.zeros_like(p) for _, p in leaves(params)]
    return {"mu": zeros, "nu": [z.clone() for z in zeros], "count": count}


# ---------------------------------------------------------------- steps

def draw(stream_seed: int, shapes: dict, device) -> dict:
    """A step's uniforms, in the order the step draws them."""
    gen = torch.Generator(device=device).manual_seed(stream_seed)
    return {name: torch.rand(shape, generator=gen, device=device)
            for name, shape in shapes.items()}


def frame_of(tree, f):
    """Frame ``f`` of a tree whose leaves carry a leading frame axis."""
    return rebuild(tree, [t[f] for _, t in leaves(tree)])


def follow(params, scenes, first_step, stream_seeds, recipe, count, products=None):
    """Run the steps ``first_step ...`` (one per stream seed) from
    ``params`` (a leading frame axis when ``len(scenes) > 1``), frame by
    frame. Returns per step the losses [F], and the first step's gradients
    and the parameters after the last step, each as a list over frames of
    ``leaves``-ordered tensors."""
    frames = len(scenes)
    stacked = frames > 1
    k = scenes[0]["candidate_weights"].shape[-1]
    r, s = recipe["num_rays"], recipe["num_samples"]
    lead = (frames,) if stacked else ()
    shapes = {"gumbel": (*lead, k), "coarse": (*lead, r, s), "fine": (*lead, r, s)}
    device = scenes[0]["valid"].device
    per_frame = [frame_of(params, f) if stacked else params for f in range(frames)]
    states = [adam_init(p, count) for p in per_frame]
    losses, first_grads = [], []
    for index, seed in enumerate(stream_seeds):
        step = first_step + index
        draws = draw(seed, shapes, device)
        step_losses = []
        for f in range(frames):
            frame_draws = {name: (d[f] if stacked else d) for name, d in draws.items()}
            p = rebuild(per_frame[f], [t.detach().requires_grad_(True)
                                       for _, t in leaves(per_frame[f])])
            ts = [t for _, t in leaves(p)]
            total = frame_loss(p, scenes[f], step, frame_draws, recipe, products)
            grads = torch.autograd.grad(total, ts, allow_unused=True)
            if index == 0:
                first_grads.append([torch.zeros_like(t) if g is None else g.detach()
                                    for t, g in zip(ts, grads)])
            step_losses.append(float(total.detach()))
            per_frame[f], states[f] = adam(rebuild(p, [t.detach() for t in ts]), grads,
                                           states[f], recipe)
            del total, grads
        losses.append(step_losses)
    return {"losses": losses, "first_grads": first_grads,
            "params": [[t for _, t in leaves(p)] for p in per_frame]}
