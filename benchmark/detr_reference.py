"""The plain reference of the detector cell: DETR-R50 with VSRD's heads, its
Hungarian-matched loss, its gradients and DETR's clipped two-rate AdamW, in
plain PyTorch operations on float32 with TF32 off, scipy's Hungarian
matching, and no kernel and no import of the port.

It follows DETR as published (Carion et al. 2020, arXiv:2005.12872;
facebookresearch/detr ``models/backbone.py``, ``position_encoding.py``,
``transformer.py``, ``matcher.py``, ``detr.py``) and reads the parameters
by the names the port's ``PublishedDETR3D.state_dict()`` gives them (the
benchmark hands it the program's initial parameters). Its departures from
the published code, each the cell's own:

* the heads are VSRD's (the port's ``PredictionHeads``): one linear layer
  each for the class logits (car and no-object), the normalized cxcywh 2D
  box (sigmoid), the confidence and the 3D box (pixel, depth ``softplus +
  1``, half-dimensions ``softplus + 0.3``, a yaw from a normalized (cos,
  sin), unprojected through K^-1), in place of DETR's COCO class layer and
  3-layer box MLP; their 3D-box L1 (the mean over the 8 corners' 3
  coordinates, summed over the matched queries over the matched count) is
  added at weight 1;
* the 2D-box L1 of the cost and the loss is on xyxy boxes, and the cost
  takes its mean over the four coordinates (DETR: cxcywh, their sum), as the
  port's loss has it;
* the images come in [0, 1] NHWC and are normalized by ImageNet's mean and
  deviation in the model (DETR: in its data transform), all of one size, so
  no padding mask;
* the matching cost pads the rectangular cost to a square with 0 (the
  invalid target slots and the columns past them), which leaves the
  matching of the valid targets as DETR's rectangular one;
* the matching is given: ``loss`` takes each level's assignment (the
  program's, so that two near-equal costs that the program's TF32 and this
  float32 order differently do not change what is compared), and
  ``hungarian_gap`` holds the program's assignment to scipy's optimum on
  this file's own matching cost (``matching_cost``, float64, from the
  program's outputs);
* dropout is an argument; the benchmark's checked steps run it at 0.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LAYERS = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
OUTPUTS = ("logits", "boxes_2d", "boxes_3d")     # what each level's heads give
FROZEN_BN_EPS = 1e-5
LAYER_NORM_EPS = 1e-5
# the KITTI-360 "evaluation" order of a box's corners, as multiples of its
# half-dimensions
UNIT_CORNERS = ((-1, -1, 1), (1, -1, 1), (1, -1, -1), (-1, -1, -1),
                (-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1))


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and convolutions while the reference runs."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def frozen_bn(p, name, x):
    """``FrozenBatchNorm2d``: (x - mean) w / sqrt(var + eps) + b."""
    w, b = p[name + ".weight"], p[name + ".bias"]
    mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    scale = w / torch.sqrt(var + FROZEN_BN_EPS)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + b[None, :, None, None]


def bottleneck(p, name, x, stride):
    out = F.relu(frozen_bn(p, name + ".bn1", F.conv2d(x, p[name + ".conv1.weight"])))
    out = F.relu(frozen_bn(p, name + ".bn2", F.conv2d(out, p[name + ".conv2.weight"],
                                                      stride=stride, padding=1)))
    out = frozen_bn(p, name + ".bn3", F.conv2d(out, p[name + ".conv3.weight"]))
    if name + ".downsample.0.weight" in p:
        x = frozen_bn(p, name + ".downsample.1",
                      F.conv2d(x, p[name + ".downsample.0.weight"], stride=stride))
    return F.relu(out + x)


def resnet50(p, x):
    """torchvision's ResNet-50 trunk to C5 (the stride on each stage's first
    3x3)."""
    x = F.relu(frozen_bn(p, "backbone.bn1", F.conv2d(x, p["backbone.conv1.weight"], stride=2,
                                                      padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, (blocks, _, stride) in enumerate(LAYERS, start=1):
        for block in range(blocks):
            x = bottleneck(p, f"backbone.layer{stage}.{block}", x, stride if block == 0 else 1)
    return x


def position_embedding(height, width, channels, device):
    """DETR's ``PositionEmbeddingSine(channels // 2, normalize=True)`` of a
    map with no padding, ``[H * W, channels]``: cumulative sums of the
    unmasked pixels normalized by the last and scaled by 2 pi."""
    npf = channels // 2
    not_mask = torch.ones(1, height, width, device=device)
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    y_embed = y_embed / (y_embed[:, -1:, :] + 1e-6) * 2 * math.pi
    x_embed = x_embed / (x_embed[:, :, -1:] + 1e-6) * 2 * math.pi
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / npf)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3)[0].reshape(height * width, channels)


def dropout(x, rate):
    return F.dropout(x, rate, training=rate > 0.0)


def attention(p, name, query, key, value, heads, rate):
    """``nn.MultiheadAttention``: the packed in-projection, the query scaled
    by 1/sqrt(head dim), softmax over the keys, dropout on the weights, the
    output projection."""
    w, b = p[name + ".in_proj_weight"], p[name + ".in_proj_bias"]
    c = w.shape[1]
    q = query @ w[:c].t() + b[:c]
    k = key @ w[c:2 * c].t() + b[c:2 * c]
    v = value @ w[2 * c:].t() + b[2 * c:]
    n, lq, lk, d = q.shape[0], q.shape[1], k.shape[1], c // heads
    q = q.reshape(n, lq, heads, d).transpose(1, 2) * d ** -0.5
    k = k.reshape(n, lk, heads, d).transpose(1, 2)
    v = v.reshape(n, lk, heads, d).transpose(1, 2)
    weights = dropout(torch.softmax(q @ k.transpose(-2, -1), dim=-1), rate)
    out = (weights @ v).transpose(1, 2).reshape(n, lq, c)
    return out @ p[name + ".out_proj.weight"].t() + p[name + ".out_proj.bias"]


def layer_norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], LAYER_NORM_EPS)


def feed_forward(p, name, x, rate):
    hidden = dropout(F.relu(x @ p[name + ".linear1.weight"].t() + p[name + ".linear1.bias"]),
                     rate)
    return hidden @ p[name + ".linear2.weight"].t() + p[name + ".linear2.bias"]


def encoder_layer(p, name, src, pos, heads, rate):
    q = src + pos
    src = layer_norm(p, name + ".norm1",
                     src + dropout(attention(p, name + ".self_attn", q, q, src, heads, rate), rate))
    return layer_norm(p, name + ".norm2", src + dropout(feed_forward(p, name, src, rate), rate))


def decoder_layer(p, name, tgt, memory, pos, query_pos, heads, rate):
    q = tgt + query_pos
    tgt = layer_norm(p, name + ".norm1",
                     tgt + dropout(attention(p, name + ".self_attn", q, q, tgt, heads, rate), rate))
    attended = attention(p, name + ".multihead_attn", tgt + query_pos, memory + pos, memory,
                         heads, rate)
    tgt = layer_norm(p, name + ".norm2", tgt + dropout(attended, rate))
    return layer_norm(p, name + ".norm3", tgt + dropout(feed_forward(p, name, tgt, rate), rate))


def heads_of(p, x, intrinsics, image_size):
    """VSRD's heads on one decoder level ``[B, Q, C]``."""
    def linear(name):
        return x @ p[f"heads.{name}.weight"].t() + p[f"heads.{name}.bias"]

    raw = linear("box_3d_regression_head")
    uv = torch.sigmoid(raw[..., :2])
    depth = F.softplus(raw[..., 2:3]) + 1.0
    half = F.softplus(raw[..., 3:6]) + 0.3
    yaw = raw[..., 6:8] / torch.clamp(raw[..., 6:8].norm(dim=-1, keepdim=True), min=1e-6)
    height, width = image_size
    pixels = torch.stack([uv[..., 0] * width, uv[..., 1] * height, torch.ones_like(uv[..., 0])],
                         dim=-1)
    location = (pixels @ torch.linalg.inv(intrinsics).transpose(1, 2)) * depth
    cos, sin = yaw[..., 0], yaw[..., 1]
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    rotation = torch.stack([torch.stack([cos, zero, sin], -1), torch.stack([zero, one, zero], -1),
                            torch.stack([-sin, zero, cos], -1)], -2)
    unit = torch.tensor(UNIT_CORNERS, dtype=x.dtype, device=x.device)
    corners = (unit * half[..., None, :]) @ rotation.transpose(-2, -1) + location[..., None, :]
    return {"logits": linear("classification_head"),
            "boxes_2d": torch.sigmoid(linear("box_2d_regression_head")),
            "boxes_3d": corners}


def forward(p, images, intrinsics, config: dict, rate: float = 0.0) -> list:
    """Every decoder level's outputs (the first level first) for images
    ``[B, H, W, 3]`` in [0, 1] and K ``[B, 3, 3]``; ``p`` maps the port's
    parameter and buffer names to tensors."""
    mean = torch.tensor(MEAN, device=images.device)[:, None, None]
    std = torch.tensor(STD, device=images.device)[:, None, None]
    x = (images.permute(0, 3, 1, 2) - mean) / std
    features = F.conv2d(resnet50(p, x), p["input_projection.weight"], p["input_projection.bias"])
    b, c, h, w = features.shape
    src = features.flatten(2).transpose(1, 2)
    pos = position_embedding(h, w, c, images.device)
    heads = config["num_heads"]
    for i in range(config["num_encoder_layers"]):
        src = encoder_layer(p, f"encoder.{i}", src, pos, heads, rate)
    query_pos = p["query_embeddings.weight"][None].expand(b, -1, -1)
    tgt = torch.zeros_like(query_pos)
    levels = []
    for i in range(config["num_decoder_layers"]):
        tgt = decoder_layer(p, f"decoder.{i}", tgt, src, pos, query_pos, heads, rate)
        levels.append(heads_of(p, layer_norm(p, "decoder_norm", tgt), intrinsics,
                               images.shape[1:3]))
    return levels


# ---------------------------------------------------------------------------
# matching and the loss
# ---------------------------------------------------------------------------

def cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_iou(a, b):
    """Elementwise GIoU of xyxy boxes (DETR's ``generalized_box_iou`` on
    matched pairs)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter_wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2]))
    inter = inter_wh.clamp(min=0).prod(-1)
    union = area_a + area_b - inter
    hull = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2]))
    enclosing = hull.clamp(min=0).prod(-1)
    return inter / union - (enclosing - union) / enclosing


def matching_cost(level, batch, config: dict) -> torch.Tensor:
    """DETR's matcher cost of one level ``[B, Q, Q]`` in float64 (``matcher.
    py``): the class weight times minus the softmax probability of the
    target's class, the L1 weight times the 2D boxes' mean absolute gap,
    minus the GIoU weight times their GIoU, against the target slots in the
    first N columns; 0 for an invalid slot and for the columns past them."""
    weights = config["matcher"]
    labels, valid = batch["labels"].long(), batch["valid"]
    prob = torch.softmax(level["logits"].double(), dim=-1)
    b, q = prob.shape[:2]
    n = labels.shape[1]
    pred = cxcywh_to_xyxy(level["boxes_2d"].double())[:, :, None]
    gt = batch["boxes_2d"].double()[:, None]
    cost = (-weights["class"] * torch.gather(prob, 2, labels[:, None, :].expand(b, q, n))
            + weights["l1"] * (pred - gt).abs().mean(-1)
            - weights["giou"] * generalized_iou(pred, gt))
    padded = torch.zeros(b, q, q, dtype=torch.float64, device=prob.device)
    padded[:, :, :n] = torch.where(valid[:, None, :], cost, 0.0)
    return padded


def cost_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The program's matching costs against the reference's, elementwise:
    the summed absolute gap over the reference's summed absolute values."""
    reference = reference.double()
    scale = float(reference.abs().sum())
    gap = float((program.detach().double().to(reference.device) - reference).abs().sum())
    return gap / scale if scale > 0.0 else math.inf


def level_loss(level, row_to_col, batch, config: dict) -> torch.Tensor:
    """One level's weighted loss for the assignment ``row_to_col [B, Q]``
    (query -> target slot; slots at or past the targets, or invalid, are
    no-object): cross-entropy with the no-object class weighted, 5 L1 + 2
    (1 - GIoU) on the 2D boxes and the 3D boxes' L1, the box terms summed
    over the matched queries over the matched count."""
    weights = config["loss"]
    labels, valid = batch["labels"].long(), batch["valid"]
    n = labels.shape[1]
    slot = row_to_col.clamp(max=n - 1)
    matched = (row_to_col < n) & torch.gather(valid, 1, slot)
    target = torch.where(matched, torch.gather(labels, 1, slot), config["num_classes"])
    class_weight = torch.ones(config["num_classes"] + 1, device=labels.device)
    class_weight[-1] = weights["no_object_weight"]
    class_loss = F.cross_entropy(level["logits"].transpose(1, 2), target, class_weight)
    count = matched.sum().clamp(min=1).float()
    m = matched.float()
    pred = cxcywh_to_xyxy(level["boxes_2d"])
    gt = torch.gather(batch["boxes_2d"], 1, slot[..., None].expand(-1, -1, 4))
    l1 = ((pred - gt).abs().sum(-1) * m).sum() / count
    giou = ((1 - generalized_iou(pred, gt)) * m).sum() / count
    gt_3d = torch.gather(batch["boxes_3d"], 1, slot[..., None, None].expand(-1, -1, 8, 3))
    box3d = ((level["boxes_3d"] - gt_3d).abs().mean((-2, -1)) * m).sum() / count
    return (weights["class"] * class_loss + weights["l1"] * l1 + weights["giou"] * giou
            + weights["box3d"] * box3d)


def loss(levels, assignments, batch, config: dict) -> torch.Tensor:
    """The sum of every level's loss, each with its assignment."""
    return sum(level_loss(level, a, batch, config) for level, a in zip(levels, assignments))


def hungarian_gap(costs: torch.Tensor, row_to_col: torch.Tensor, valid: torch.Tensor) -> float:
    """The program's assignments against scipy's optimum on the costs
    ``[L * B, Q, Q]`` (``matching_cost``'s, level-major; ``valid [B, N]``:
    target slot j of image b is column j): per matrix the excess of the
    assignment's cost on the valid columns over the optimum's, in float64,
    over the optimum's absolute cost there; the largest. The other columns
    cost the same for every query, so a perfect matching's cost there is
    fixed, and an assignment that only swaps two near-equal costs reads at
    their difference."""
    costs = costs.detach().double().cpu().numpy()
    row_to_col = row_to_col.detach().cpu().numpy()
    valid = valid.detach().cpu().numpy()
    b, n = valid.shape
    worst = 0.0
    for index, (cost, assigned) in enumerate(zip(costs, row_to_col)):
        columns = np.flatnonzero(valid[index % b])
        rows, cols = linear_sum_assignment(cost)
        optimum = np.zeros(cost.shape[1], dtype=np.int64)
        optimum[cols] = rows
        program = np.zeros(cost.shape[1], dtype=np.int64)
        program[assigned] = np.arange(cost.shape[0])
        if len(np.unique(assigned)) != len(assigned):
            return math.inf     # not a matching
        best = sum(cost[optimum[j], j] for j in columns)
        got = sum(cost[program[j], j] for j in columns)
        worst = max(worst, (got - best) / max(sum(abs(cost[optimum[j], j]) for j in columns),
                                              1e-30))
    return worst


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def clip_(grads, max_norm):
    """The gradients scaled to a global norm of at most ``max_norm``
    (``clip_grad_norm_``: by max_norm / (norm + 1e-6) where that is below 1)."""
    total = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [g * scale for g in grads]


class AdamW:
    """AdamW (Loshchilov and Hutter), as ``torch.optim.AdamW`` computes it:
    the decay first (p <- p (1 - lr wd)), then the moments and the bias-
    corrected step lr / (1 - b1^t) m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, rates: dict, optimizer: dict):
        self.rates = rates
        self.b1, self.b2 = optimizer["betas"]
        self.eps, self.wd = optimizer["eps"], optimizer["weight_decay"]
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, g in grads.items():
            lr = self.rates[name]
            p = params[name]
            m = self.m[name] = self.b1 * self.m.get(name, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.v[name] = (self.b2 * self.v.get(name, torch.zeros_like(g))
                                + (1 - self.b2) * g * g)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr / c1 * m / (torch.sqrt(v) / math.sqrt(c2) + self.eps))


def follow(initial: dict, trained: list, batches: list, assignments: list, config: dict,
           autocast_dtype=None) -> dict:
    """The checked steps from the program's initial state (``initial``:
    every parameter and buffer by name; ``trained``: the names that take a
    gradient, the backbone's under ``backbone.``), one batch and one
    assignment (a level list) per step, dropout 0: each step's loss, the
    first step's outputs on every level (first level first), its gradient
    with respect to them and its gradient before the clip, the trained
    parameters after the steps.
    ``autocast_dtype``: the control, every operation under autocast to that
    lower precision."""
    opt = config["optimizer"]
    params = {k: v.detach().clone() for k, v in initial.items()}
    rates = {k: opt["lr_backbone"] if k.startswith("backbone.") else opt["lr"] for k in trained}
    adamw = AdamW(rates, opt)
    losses, first, outputs, output_grads = [], None, None, None
    device = next(iter(params.values())).device
    lower = (torch.autocast(device.type, dtype=autocast_dtype) if autocast_dtype is not None
             else contextlib.nullcontext())
    with float32_products():
        for batch, assignment in zip(batches, assignments):
            leaves = {k: params[k].requires_grad_(True) for k in trained}
            with lower:
                levels = forward(params, batch["images"], batch["intrinsics"], config)
                total = loss(levels, assignment, batch, config)
            ends = [level[k] for level in levels for k in OUTPUTS] if first is None else []
            grads = torch.autograd.grad(total.float(), [leaves[k] for k in trained] + ends,
                                        allow_unused=True)
            grads, ends = grads[:len(trained)], grads[len(trained):]
            # a parameter the loss does not reach (the confidence head) has a zero gradient
            grads = [torch.zeros_like(leaves[k]) if g is None else g.float()
                     for k, g in zip(trained, grads)]
            if first is None:
                first = [g.clone() for g in grads]
                outputs = [{k: v.detach().float() for k, v in level.items()} for level in levels]
                output_grads = [dict(zip(OUTPUTS, ends[i:i + len(OUTPUTS)]))
                                for i in range(0, len(ends), len(OUTPUTS))]
                output_grads = [{k: g.detach().float() for k, g in level.items()}
                                for level in output_grads]
            grads = clip_(grads, opt["clip_max_norm"])
            for k in trained:
                params[k] = params[k].detach()
            losses.append(float(total.detach()))
            adamw.step(params, dict(zip(trained, grads)))
    return {"losses": [[x] for x in losses], "first_grads": [first], "outputs": outputs,
            "output_grads": output_grads, "params": [[params[k] for k in trained]]}
