"""DETR-style 3D detectors trained on the pseudo-labels.

Counterpart of ``vsrd_tpu/models/detr3d.py``: a small strided CNN backbone,
a transformer encoder over its tokens, a decoder of learned queries (full
cross-attention in ``DETR3D``, deformable sampling around learned reference
points in ``DeformableDETR3D``), and heads for class logits, normalized 2D
boxes, 3D boxes decoded by pixel + depth unprojection, and confidences;
``detr_loss`` matches queries to targets by JV (``ops/matching.py``: one
launch of the hand-written kernel for every image and decoder level on a
card) and adds the DETR losses.

Images come in NHWC in [0, 1], as in the JAX package, and go NCHW through
the convolutions. Every submodule carries its flax name (``backbone``,
``encoder_0``, ``decoder_self_0``, ``heads.classification_head``,
``decoder_deformable_0.sampling_offsets``, ``LayerNorm_0`` ...), so that
``utils/convert.py`` maps a flax parameter tree onto ``state_dict()`` by path
and ``parameter_group_of`` puts the same parameters in the same group. The
numerics follow flax: SAME padding of the stride-2 convolutions (lo =
total // 2), eps 1e-6 in LayerNorm and GroupNorm, GELU's tanh form, and
initializers of the same distributions (``make_detector`` draws them from
a seed; a flax checkpoint loads through ``convert.detector_params_from_jax``).

``PublishedDETR3D`` (``make_detector(arch="detr-r50")``) is DETR as
published (Carion et al. 2020, arXiv:2005.12872; facebookresearch/detr),
which the JAX package does not have: a ResNet-50 with frozen batch norms,
post-norm encoder and decoder layers with the sine positions at every
attention, 100 queries, with the same heads on all six decoder levels. Its
training recipe (``TrainingRecipe``: two learning rates, clipping, the
auxiliary levels, GIoU and the no-object weight) rides on the class, and
``pipeline/detector_training.py`` follows it. A forward names its stages
(``utils/spans.py``: ``det.backbone``, ``det.transformer``) and
``detr_loss`` its own (``det.match``, ``det.loss``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..modules.attention import MultiHeadDeformableAttention
from ..modules.blocks import ResNet50
from ..ops import iou2d, matching
from ..ops.geometry import rotation_matrix_y_from_cos_sin
from ..utils import spans
from .box_parameters import decode_box_3d

NORM_EPS = 1e-6        # flax's LayerNorm and GroupNorm
ARCHS = ("detr3d", "deformable", "detr-r50")


@dataclasses.dataclass(frozen=True)
class TrainingRecipe:
    """How ``pipeline/detector_training.py`` trains a detector class:
    ``backbone_lr`` (None: one learning rate for every parameter) for the
    trained parameters under ``backbone.``; the global gradient norm
    clipped to ``max_norm`` (None: no clipping); the loss on every decoder
    level (``aux_loss``); GIoU in place of IoU in the matching cost and the
    loss; the class loss's weight of the no-object class."""

    backbone_lr: float | None = None
    max_norm: float | None = None
    aux_loss: bool = False
    giou: bool = False
    no_object_weight: float = 1.0


def positional_encoding_2d(height, width, channels, temperature=10000.0, device=None):
    """DETR's sine positional encoding ``[H, W, C]``: y's half, then x's."""
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    half = channels // 2
    dim_t = temperature ** (
        2 * torch.div(torch.arange(half, dtype=torch.float32, device=device), 2,
                      rounding_mode="floor") / half)
    pos_x = xs[..., None] / dim_t
    pos_y = ys[..., None] / dim_t
    pos_x = torch.cat([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])], dim=-1)
    pos_y = torch.cat([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])], dim=-1)
    return torch.cat([pos_y.expand(height, width, half), pos_x.expand(height, width, half)],
                     dim=-1)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` along one axis: ``ceil(size / stride)``
    outputs, the total padding split with the smaller half first (so a
    3x3 stride-2 convolution of an even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A convolution with flax's SAME padding, computed per input size."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class ConvBackbone(nn.Module):
    """Four 3x3 stride-2 convolutions, each with GroupNorm (gcd(32, ch)
    groups) and ReLU: stride 16, NCHW."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 256)):
        super().__init__()
        self.channels = tuple(channels)
        in_channels = 3
        for index, ch in enumerate(self.channels):
            self.add_module(f"Conv_{index}", SameConv2d(in_channels, ch, 3, stride=2))
            self.add_module(f"GroupNorm_{index}", nn.GroupNorm(math.gcd(32, ch), ch,
                                                               eps=NORM_EPS))
            in_channels = ch

    def forward(self, x):
        for index in range(len(self.channels)):
            x = getattr(self, f"Conv_{index}")(x)
            x = F.relu(getattr(self, f"GroupNorm_{index}")(x))
        return x


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``nn.MultiHeadDotProductAttention`` with every width equal (the
    layer's use): the queries scaled by ``1/sqrt(head_dim)``."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, inputs_q, inputs_kv):
        b, nq, _ = inputs_q.shape
        h = self.num_heads
        q = self.query(inputs_q).reshape(b, nq, h, -1)
        k = self.key(inputs_kv).reshape(b, inputs_kv.shape[1], h, -1)
        v = self.value(inputs_kv).reshape(b, inputs_kv.shape[1], h, -1)
        q = q / math.sqrt(q.shape[-1])
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, nq, -1))


class TransformerLayer(nn.Module):
    """Pre-norm attention (self, or cross with ``keys_values``) and a GELU
    MLP of width ``mlp_dim``, each residual."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, mlp_dim: int = 1024):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(hidden_dim, num_heads)
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=NORM_EPS)
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=NORM_EPS)
        self.LayerNorm_2 = nn.LayerNorm(hidden_dim, eps=NORM_EPS)
        self.Dense_0 = nn.Linear(hidden_dim, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, hidden_dim)

    def forward(self, queries, keys_values=None):
        kv = queries if keys_values is None else keys_values
        x = queries + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(queries),
                                                          self.LayerNorm_1(kv))
        y = F.gelu(self.Dense_0(self.LayerNorm_2(x)), approximate="tanh")
        return x + self.Dense_1(y)


class PredictionHeads(nn.Module):
    """Class logits (+1 no-object), normalized cxcywh 2D boxes,
    confidences, and 3D boxes: normalized pixel (u, v) (relative to the
    query's reference point when given), depth ``softplus + 1``,
    half-dimensions ``softplus + 0.3`` and a yaw from (cos, sin),
    unprojected through ``K^-1``. Shared by every decoder level."""

    def __init__(self, hidden_dim: int, num_classes: int):
        super().__init__()
        self.classification_head = nn.Linear(hidden_dim, num_classes + 1)
        self.box_2d_regression_head = nn.Linear(hidden_dim, 4)
        self.confidence_prediction_head = nn.Linear(hidden_dim, 1)
        self.box_3d_regression_head = nn.Linear(hidden_dim, 8)

    def forward(self, queries, intrinsic_matrices, image_size, reference_uv=None):
        logits = self.classification_head(queries)
        boxes_2d = torch.sigmoid(self.box_2d_regression_head(queries))
        confidences = torch.sigmoid(self.confidence_prediction_head(queries))[..., 0]
        raw = self.box_3d_regression_head(queries)
        if reference_uv is None:
            uv = torch.sigmoid(raw[..., :2])
        else:
            uv = torch.sigmoid(raw[..., :2] + torch.logit(
                torch.clamp(reference_uv, 1e-4, 1.0 - 1e-4)))
        depth = F.softplus(raw[..., 2:3]) + 1.0
        dims = F.softplus(raw[..., 3:6]) + 0.3
        cos_sin = raw[..., 6:8]
        cos_sin = cos_sin / torch.clamp(torch.linalg.vector_norm(cos_sin, dim=-1, keepdim=True),
                                        min=1e-6)
        height, width = image_size
        pixels = torch.stack([uv[..., 0] * width, uv[..., 1] * height,
                              torch.ones_like(uv[..., 0])], dim=-1)
        # inv_ex: the same inverse without inv's error check, which waits on the device
        inverse = torch.linalg.inv_ex(intrinsic_matrices).inverse
        rays = torch.einsum("bij,bqj->bqi", inverse, pixels)
        locations = rays * depth
        rotations = rotation_matrix_y_from_cos_sin(cos_sin[..., 0], cos_sin[..., 1])
        return {
            "logits": logits,
            "boxes_2d": boxes_2d,
            "boxes_3d": decode_box_3d(locations, dims, rotations),
            "locations": locations,
            "dimensions": dims,
            "confidences": confidences,
        }


class DETR3D(nn.Module):
    """Feed-forward 3D detector: ``forward(images [B, H, W, 3], K [B, 3, 3])``
    gives per query the class logits, normalized cxcywh 2D boxes, 8-corner
    camera-space 3D boxes and confidences; with ``aux_outputs`` also the
    same heads on every earlier decoder layer."""

    recipe = TrainingRecipe()     # the JAX package's step

    def __init__(self, num_classes: int = 1, num_queries: int = 50, hidden_dim: int = 256,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3, num_heads: int = 8):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.num_heads = num_heads
        self.backbone = ConvBackbone()
        self.input_projection = nn.Linear(self.backbone.channels[-1], hidden_dim)
        for index in range(num_encoder_layers):
            self.add_module(f"encoder_{index}", TransformerLayer(hidden_dim, num_heads))
        self.query_embeddings = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.heads = PredictionHeads(hidden_dim, num_classes)
        self._decoder_modules()

    def _decoder_modules(self):
        for index in range(self.num_decoder_layers):
            self.add_module(f"decoder_self_{index}",
                            TransformerLayer(self.hidden_dim, self.num_heads))
            self.add_module(f"decoder_cross_{index}",
                            TransformerLayer(self.hidden_dim, self.num_heads))

    def encode(self, images):
        """Backbone, projection, positional encoding and encoder: the
        tokens ``[B, h*w, C]`` and the feature map's ``(h, w)``."""
        with spans.span(spans.DETECTOR_BACKBONE):
            features = self.backbone(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            b, h, w, _ = features.shape
            tokens = self.input_projection(features)
            tokens = tokens + positional_encoding_2d(h, w, self.hidden_dim, device=tokens.device)
            tokens = tokens.reshape(b, h * w, self.hidden_dim)
        with spans.span(spans.DETECTOR_TRANSFORMER):
            for index in range(self.num_encoder_layers):
                tokens = getattr(self, f"encoder_{index}")(tokens)
        return tokens, (h, w)

    def decode(self, index, queries, tokens, shape):
        queries = getattr(self, f"decoder_self_{index}")(queries)
        return getattr(self, f"decoder_cross_{index}")(queries, tokens)

    def reference_uv(self, batch):
        return None

    def forward(self, images, intrinsic_matrices, aux_outputs: bool = False):
        tokens, shape = self.encode(images)
        with spans.span(spans.DETECTOR_TRANSFORMER):
            b = images.shape[0]
            queries = self.query_embeddings.expand(b, -1, -1)
            intermediate = []
            for index in range(self.num_decoder_layers):
                queries = self.decode(index, queries, tokens, shape)
                intermediate.append(queries)
            reference = self.reference_uv(b)
            outputs = predict(self.heads, intermediate, intrinsic_matrices, images.shape[1:3],
                              aux_outputs, reference)
        return outputs


def predict(heads, levels, intrinsic_matrices, image_size, aux_outputs: bool,
            reference=None) -> dict:
    """The heads on the last decoder level, and with ``aux_outputs`` on each
    earlier one under ``aux_outputs``."""
    outputs = heads(levels[-1], intrinsic_matrices, image_size, reference)
    if reference is not None:
        outputs["reference_points"] = reference
    if aux_outputs:
        outputs["aux_outputs"] = [heads(level, intrinsic_matrices, image_size, reference)
                                  for level in levels[:-1]]
    return outputs


class DeformableDETR3D(DETR3D):
    """The deformable variant: each decoder layer's cross-attention samples
    ``num_samples`` locations of the encoded map per query, and learned
    per-query reference points anchor the 3D location head (pass
    ``focal_matching=True`` to ``detr_loss`` for its focal class cost)."""

    def __init__(self, num_classes: int = 1, num_queries: int = 50, hidden_dim: int = 256,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3, num_heads: int = 8,
                 num_samples: int = 8):
        self.num_samples = num_samples
        super().__init__(num_classes, num_queries, hidden_dim, num_encoder_layers,
                         num_decoder_layers, num_heads)
        self.reference_points = nn.Parameter(torch.zeros(num_queries, 2))

    def _decoder_modules(self):
        for index in range(self.num_decoder_layers):
            self.add_module(f"decoder_self_{index}",
                            TransformerLayer(self.hidden_dim, self.num_heads))
            self.add_module(f"decoder_deformable_{index}", MultiHeadDeformableAttention(
                self.hidden_dim, self.hidden_dim, self.num_samples, self.num_heads))

    def decode(self, index, queries, tokens, shape):
        queries = getattr(self, f"decoder_self_{index}")(queries)
        maps = tokens.reshape(tokens.shape[0], *shape, self.hidden_dim)
        return queries + getattr(self, f"decoder_deformable_{index}")(queries, maps, maps)

    def reference_uv(self, batch):
        return torch.sigmoid(self.reference_points)[None].expand(batch, -1, -1)


# ---------------------------------------------------------------------------
# DETR at its published widths
# ---------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sine_positions(height: int, width: int, num_pos_feats: int = 128,
                   temperature: float = 10000.0, device=None) -> torch.Tensor:
    """DETR's ``PositionEmbeddingSine(normalize=True)`` of an unpadded
    ``height x width`` map, ``[height * width, 2 num_pos_feats]`` row-major:
    the row's coordinate then the column's, each ``(1..n) / n`` scaled by
    2 pi, over ``temperature^(2 floor(i / 2) / num_pos_feats)``, sines and
    cosines interleaved."""
    scale = 2.0 * math.pi
    ys = torch.arange(1, height + 1, dtype=torch.float32, device=device) / (height + 1e-6) * scale
    xs = torch.arange(1, width + 1, dtype=torch.float32, device=device) / (width + 1e-6) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def embed(coords):
        pos = coords[:, None] / dim_t
        return torch.stack((pos[:, 0::2].sin(), pos[:, 1::2].cos()), dim=2).flatten(1)

    pos_y = embed(ys)[:, None, :].expand(height, width, num_pos_feats)
    pos_x = embed(xs)[None, :, :].expand(height, width, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(height * width, 2 * num_pos_feats)


class PackedAttention(nn.Module):
    """``nn.MultiheadAttention`` as DETR uses it, on batch-first tensors: q,
    k and v from one packed in-projection ``[3C, C]``, ``num_heads`` heads of
    scaled dot-product attention with dropout on the attention weights in
    training, and an output projection."""

    def __init__(self, features: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * features, features))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * features))
        self.out_proj = nn.Linear(features, features)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query, key, value):
        b, nq, c = query.shape
        weights = self.in_proj_weight.chunk(3)
        biases = self.in_proj_bias.chunk(3)
        q, k, v = (F.linear(x, w, bias).reshape(b, x.shape[1], self.num_heads, -1).transpose(1, 2)
                   for x, w, bias in zip((query, key, value), weights, biases))
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout.p if self.training else 0.0)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, c))


class PostNormEncoderLayer(nn.Module):
    """DETR's ``TransformerEncoderLayer`` (``normalize_before=False``): self-
    attention with the positions added to queries and keys, then a ReLU MLP,
    each residual with dropout and followed by its LayerNorm."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.self_attn = PackedAttention(hidden_dim, num_heads, dropout)
        self.linear1 = nn.Linear(hidden_dim, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim)
        self.norm2 = nn.LayerNorm(hidden_dim)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, tokens, pos):
        q = tokens + pos
        tokens = self.norm1(tokens + self.dropout1(self.self_attn(q, q, tokens)))
        mlp = self.linear2(self.dropout(F.relu(self.linear1(tokens))))
        return self.norm2(tokens + self.dropout2(mlp))


class PostNormDecoderLayer(nn.Module):
    """DETR's ``TransformerDecoderLayer`` (``normalize_before=False``): self-
    attention with the query positions added to queries and keys, cross-
    attention with the query positions on the queries and the map's
    positions on the keys, then a ReLU MLP; each residual with dropout and
    followed by its LayerNorm."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.self_attn = PackedAttention(hidden_dim, num_heads, dropout)
        self.multihead_attn = PackedAttention(hidden_dim, num_heads, dropout)
        self.linear1 = nn.Linear(hidden_dim, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim)
        self.norm2 = nn.LayerNorm(hidden_dim)
        self.norm3 = nn.LayerNorm(hidden_dim)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)

    def forward(self, targets, memory, pos, query_pos):
        q = targets + query_pos
        targets = self.norm1(targets + self.dropout1(self.self_attn(q, q, targets)))
        attended = self.multihead_attn(targets + query_pos, memory + pos, memory)
        targets = self.norm2(targets + self.dropout2(attended))
        mlp = self.linear2(self.dropout(F.relu(self.linear1(targets))))
        return self.norm3(targets + self.dropout3(mlp))


class PublishedDETR3D(nn.Module):
    """DETR-R50 (arXiv:2005.12872, facebookresearch/detr ``models/``) with
    VSRD's heads: ``forward(images [B, H, W, 3] in [0, 1], K [B, 3, 3])``
    as ``DETR3D``'s.

    The images are normalized by ImageNet's mean and deviation (DETR's
    transform), then ``ResNet50`` (frozen norms, stem and ``layer1``
    frozen), a 1x1 projection of C5 to ``hidden_dim`` channels and the
    normalized sine positions (``sine_positions``) of its map. Encoder and
    decoder layers are post-norm with ReLU MLPs and dropout; the decoder
    starts from zeros, with the query embeddings as the queries' positions,
    and its final LayerNorm takes every level's output, on each of which the
    heads (``PredictionHeads``) sit. The widths are DETR's published ones
    by default (256, 8 heads, MLP 2048, dropout 0.1, 6 + 6 layers, 100
    queries)."""

    recipe = TrainingRecipe(backbone_lr=1e-5, max_norm=0.1, aux_loss=True, giou=True,
                            no_object_weight=0.1)

    def __init__(self, num_classes: int = 1, num_queries: int = 100, hidden_dim: int = 256,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6, num_heads: int = 8,
                 mlp_dim: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.backbone = ResNet50()
        self.input_projection = nn.Conv2d(ResNet50.channels, hidden_dim, 1)
        self.encoder = nn.ModuleList(
            PostNormEncoderLayer(hidden_dim, num_heads, mlp_dim, dropout)
            for _ in range(num_encoder_layers))
        self.decoder = nn.ModuleList(
            PostNormDecoderLayer(hidden_dim, num_heads, mlp_dim, dropout)
            for _ in range(num_decoder_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim)
        self.query_embeddings = nn.Embedding(num_queries, hidden_dim)
        self.heads = PredictionHeads(hidden_dim, num_classes)
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD)[:, None, None],
                             persistent=False)

    def features(self, images):
        """The projected C5 map's tokens ``[B, h*w, C]`` and their positions
        ``[h*w, C]``."""
        x = (images.permute(0, 3, 1, 2) - self.pixel_mean) / self.pixel_std
        features = self.input_projection(self.backbone(x))
        b, c, h, w = features.shape
        return (features.flatten(2).transpose(1, 2),
                sine_positions(h, w, c // 2, device=features.device))

    def forward(self, images, intrinsic_matrices, aux_outputs: bool = False):
        with spans.span(spans.DETECTOR_BACKBONE):
            tokens, pos = self.features(images)
        with spans.span(spans.DETECTOR_TRANSFORMER):
            for layer in self.encoder:
                tokens = layer(tokens, pos)
            query_pos = self.query_embeddings.weight[None].expand(tokens.shape[0], -1, -1)
            targets = torch.zeros_like(query_pos)
            levels = []
            for layer in self.decoder:
                targets = layer(targets, tokens, pos, query_pos)
                levels.append(self.decoder_norm(targets))
            return predict(self.heads, levels, intrinsic_matrices, images.shape[1:3],
                           aux_outputs)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """DETR's initialization, drawn from ``generator``: torchvision's for
        the backbone (``ResNet50.init_weights_``); every matrix of the
        transformer xavier-uniform (DETR's ``_reset_parameters``), the
        attention's biases 0 and the MLPs' as ``nn.Linear``'s; the input
        projection and the heads as ``nn.Conv2d``'s and ``nn.Linear``'s
        (He-uniform with a = sqrt(5), biases uniform in +-1/sqrt(fan_in));
        the query embeddings N(0, 1) (``nn.Embedding``'s); norms the
        identity. The frozen norms' statistics come from ``calibrate_``."""
        self.backbone.init_weights_(generator)
        for module in (self.input_projection, *self.heads.children(), *self.encoder.modules(),
                       *self.decoder.modules()):
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                _torch_default_init_(module, generator)
        for param in [*self.encoder.parameters(), *self.decoder.parameters()]:
            if param.dim() > 1:
                nn.init.xavier_uniform_(param, generator=generator)
        for module in [*self.encoder.modules(), *self.decoder.modules()]:
            if isinstance(module, PackedAttention):
                nn.init.zeros_(module.in_proj_bias)
                nn.init.zeros_(module.out_proj.bias)
        nn.init.normal_(self.query_embeddings.weight, 0.0, 1.0, generator=generator)
        return self

    @torch.no_grad()
    def calibrate_(self, generator: torch.Generator, batch: int = 4, size: int = 192):
        """The frozen norms' statistics from a calibration batch of ``batch``
        uniform images of ``size x size`` drawn from ``generator`` (there are
        no pretrained statistics here): each norm normalizes its own input on
        the batch (``ResNet50.calibrate_``)."""
        images = torch.rand(batch, size, size, 3, generator=generator)
        x = (images.permute(0, 3, 1, 2) - self.pixel_mean) / self.pixel_std
        self.backbone.calibrate_(x)
        return self


def _torch_default_init_(module: nn.Module, generator: torch.Generator):
    """``nn.Linear``'s and ``nn.Conv2d``'s own ``reset_parameters``, drawn from
    ``generator``."""
    nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5), generator=generator)
    if module.bias is not None:
        fan_in = module.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        nn.init.uniform_(module.bias, -bound, bound, generator=generator)


def set_dropout(model: nn.Module, p: float) -> None:
    """Every dropout of ``model`` (``nn.Dropout`` modules, the attention's
    among them) at rate ``p``."""
    for module in model.modules():
        if isinstance(module, nn.Dropout):
            module.p = p


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal of variance 1/fan_in truncated at
    two standard deviations (scaled back to that variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def _init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw the parameters as flax initializes them: dense and convolution
    kernels ``lecun_normal`` over their fan-in, biases 0, norms' scales 1,
    the query embeddings N(0, 0.02) and the reference points N(0, 1)."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            _lecun_normal_(module.weight, module.weight[0].numel(), generator)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(module.weight)
        else:
            continue
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    nn.init.normal_(model.query_embeddings, 0.0, 0.02, generator=generator)
    if isinstance(model, DeformableDETR3D):
        nn.init.normal_(model.reference_points, 0.0, 1.0, generator=generator)
    return model


def make_detector(arch: str = "detr3d", seed: int = 0, device: torch.device | str = "cuda",
                  **kwargs) -> nn.Module:
    """The detector ``arch`` (``ARCHS``) with ``kwargs``, its parameters
    drawn from ``seed`` on the CPU (the same on every device) and moved to
    ``device``: ``DETR3D`` ("detr3d") or ``DeformableDETR3D`` ("deformable"),
    initialized as flax does; ``PublishedDETR3D`` ("detr-r50"), initialized
    as DETR and its frozen norms calibrated from the same generator."""
    if arch not in ARCHS:
        raise ValueError(f"no detector {arch!r}: one of {ARCHS}")
    generator = torch.Generator().manual_seed(int(seed))
    if arch == "detr-r50":
        model = PublishedDETR3D(**kwargs).init_weights_(generator).calibrate_(generator)
        return model.to(device)
    model = (DeformableDETR3D if arch == "deformable" else DETR3D)(**kwargs)
    return _init_like_flax(model, generator).to(device)


# ---------------------------------------------------------------------------
# per-subsystem parameter groups
# ---------------------------------------------------------------------------

PARAMETER_GROUPS = ("backbone", "heads", "reference_points", "sampling_offsets", "transformer")


def parameter_group_of(path) -> str:
    """A parameter's group from its name (``"backbone.Conv_0.weight"``) or
    path of names: backbone, the four heads, the reference points, the
    deformable sampling offsets, and everything else as the transformer."""
    names = path.split(".") if isinstance(path, str) else [str(getattr(p, "key", p))
                                                          for p in path]
    for name in names:
        if name in ("backbone", "heads", "reference_points"):
            return name
        if "sampling_offsets" in name:
            return "sampling_offsets"
    return "transformer"


def parameter_group_labels(model: nn.Module) -> dict:
    """``{parameter name: group}`` over ``model.named_parameters()``."""
    return {name: parameter_group_of(name) for name, _ in model.named_parameters()}


def make_param_group_optimizer(model: nn.Module, learning_rates: dict,
                               default_lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with one parameter group per subsystem, each at its learning
    rate (``learning_rates`` by group name; ``default_lr`` for the rest)."""
    groups = {group: [] for group in PARAMETER_GROUPS}
    for name, param in model.named_parameters():
        groups[parameter_group_of(name)].append(param)
    return torch.optim.Adam([
        {"params": params, "lr": learning_rates.get(group, default_lr), "name": group}
        for group, params in groups.items() if params])


# ---------------------------------------------------------------------------
# Hungarian-matched losses
# ---------------------------------------------------------------------------

def cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


@torch.no_grad()
def matching_cost(outputs, gt_labels, gt_boxes_2d, gt_valid, focal_matching=False, giou=False):
    """The padded ``[B, Q, Q]`` matching cost of one decoder level: class
    cost (or the focal one) + 5 L1 + 2 (-IoU, or -GIoU with ``giou``)
    against the N <= Q targets in the first N columns, 0 for invalid
    targets and the padding.

    Every query is a real row, so a uniform pad gives the same matching of
    the valid targets whatever its value (a perfect matching puts the same
    number of queries on padded columns), as DETR's rectangular matching
    does. The value sets only the JV's f32 rounding: at a pad of 1e6 (the
    JAX package's) the dual potentials reach 1e6, where f32 resolves 0.06,
    and the solve can miss the optimum by that much; at 0 it is exact."""
    probs = torch.softmax(outputs["logits"], dim=-1)
    pd_boxes = cxcywh_to_xyxy(outputs["boxes_2d"])
    b, q = probs.shape[:2]
    n = gt_labels.shape[1]
    if n > q:
        raise ValueError(f"{n} target slots for {q} queries: max_boxes must not exceed "
                         "num_queries")
    p = torch.gather(probs, 2, gt_labels[:, None, :].expand(b, q, n).long())   # [B, Q, N]
    if focal_matching:
        alpha, gamma = 0.25, 2.0
        pos = alpha * ((1.0 - p) ** gamma) * (-torch.log(p + 1e-8))
        neg = (1.0 - alpha) * (p ** gamma) * (-torch.log(1.0 - p + 1e-8))
        class_cost = pos - neg
    else:
        class_cost = -p
    box_cost = torch.mean(torch.abs(pd_boxes[:, :, None] - gt_boxes_2d[:, None]), dim=-1)
    overlap = iou2d.generalized_box_iou if giou else iou2d.box_iou
    iou_cost = -overlap(pd_boxes, gt_boxes_2d)
    cost = class_cost + 5.0 * box_cost + 2.0 * iou_cost
    padded = cost.new_zeros((b, q, q))
    padded[:, :, :n] = torch.where(gt_valid[:, None, :], cost, 0.0)
    return padded


def _single_level_loss(outputs, row_to_col, gt_labels, gt_boxes_2d, gt_boxes_3d, gt_valid,
                       num_classes, distributed, giou=False, no_object_weight=1.0):
    logits = outputs["logits"]
    pd_boxes = cxcywh_to_xyxy(outputs["boxes_2d"])
    pd_boxes_3d = outputs["boxes_3d"]
    n = gt_labels.shape[1]
    safe_col = torch.clamp(row_to_col, 0, n - 1)
    matched = (row_to_col < n) & torch.gather(gt_valid, 1, safe_col)

    tgt_labels = torch.gather(gt_labels.long(), 1, safe_col)
    tgt_labels = torch.where(matched, tgt_labels, num_classes)
    log_probs = torch.log_softmax(logits, dim=-1)
    class_losses = -torch.gather(log_probs, 2, tgt_labels[..., None])[..., 0]
    # the weighted mean of cross-entropy with a class weight: the no-object
    # class's at no_object_weight (1: the plain mean)
    class_weights = torch.where(tgt_labels == num_classes, no_object_weight, 1.0)
    class_loss = torch.sum(class_losses * class_weights) / torch.sum(class_weights)

    num_boxes = torch.sum(matched.to(torch.float32))
    if distributed:
        # the mean over processes, as the JAX step's pmean
        num_boxes = num_boxes.clone()
        dist.all_reduce(num_boxes)
        num_boxes = num_boxes / dist.get_world_size()
    num_boxes = torch.clamp(num_boxes, min=1.0)

    weight = matched.to(logits.dtype)
    tgt_boxes = torch.gather(gt_boxes_2d, 1, safe_col[..., None].expand(-1, -1, 4))
    l1 = torch.sum(torch.abs(pd_boxes - tgt_boxes) * weight[..., None], dim=-1)
    box_loss = torch.sum(l1) / num_boxes
    overlap = iou2d.elementwise_generalized_box_iou if giou else iou2d.elementwise_box_iou
    iou = overlap(pd_boxes, tgt_boxes)
    iou_loss = torch.sum((1.0 - iou) * weight) / num_boxes
    tgt_boxes_3d = torch.gather(gt_boxes_3d, 1,
                                safe_col[..., None, None].expand(-1, -1, 8, 3))
    l1_3d = torch.mean(torch.abs(pd_boxes_3d - tgt_boxes_3d), dim=(-2, -1))
    box3d_loss = torch.sum(l1_3d * weight) / num_boxes
    return {
        "class_loss": class_loss,
        "box_loss": box_loss,
        "iou_loss": iou_loss,
        "box3d_loss": box3d_loss,
        "num_boxes": num_boxes,
    }


def detr_loss(
    outputs: dict,
    gt_labels,        # [B, N] int (class index; padded entries arbitrary)
    gt_boxes_2d,      # [B, N, 4] normalized xyxy
    gt_boxes_3d,      # [B, N, 8, 3]
    gt_valid,         # [B, N] bool
    num_classes: int = 1,
    class_weight: float = 1.0,
    box_weight: float = 5.0,
    iou_weight: float = 2.0,
    box3d_weight: float = 1.0,
    focal_matching: bool = False,
    distributed: bool = False,
    row_to_col=None,
    giou: bool = False,
    no_object_weight: float = 1.0,
):
    """Hungarian-matched DETR losses: ``(total, scalars)``.

    Every level (the outputs and each entry of ``aux_outputs``) is matched
    on its own, image by image, and its weighted losses added; the scalars
    carry the last level's terms and ``aux{i}_<name>`` for the others. All
    levels' costs go to one JV solve (one kernel launch on a card, one JV
    per (level, image) inside). ``row_to_col`` (one ``[B, Q]`` tensor per
    level) replaces the solve. With ``distributed`` the matched-box count
    that normalizes the box losses is the mean over the processes. ``giou``
    and ``no_object_weight``: DETR's GIoU in the cost and the loss, and its
    class weight of the no-object class (the defaults are the JAX package's
    IoU and plain mean).
    """
    levels = [outputs] + list(outputs.get("aux_outputs", []))
    if row_to_col is None:
        with spans.span(spans.DETECTOR_MATCH):
            costs = torch.cat([matching_cost(level, gt_labels, gt_boxes_2d, gt_valid,
                                             focal_matching, giou)
                               for level in levels])
            row_to_col = matching.linear_sum_assignment(costs).reshape(
                len(levels), -1, costs.shape[-1]).unbind(0)

    def weighted(terms):
        return (class_weight * terms["class_loss"] + box_weight * terms["box_loss"]
                + iou_weight * terms["iou_loss"] + box3d_weight * terms["box3d_loss"])

    total, scalars = None, {}
    with spans.span(spans.DETECTOR_LOSS):
        for index, (level, assignment) in enumerate(zip(levels, row_to_col)):
            terms = _single_level_loss(level, assignment.to(gt_valid.device), gt_labels,
                                       gt_boxes_2d, gt_boxes_3d, gt_valid, num_classes,
                                       distributed, giou, no_object_weight)
            total = weighted(terms) if total is None else total + weighted(terms)
            prefix = "" if index == 0 else f"aux{index - 1}_"
            scalars.update({prefix + k: v for k, v in terms.items()})
    return total, scalars
