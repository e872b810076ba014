"""The work a training step of the detector cell asks of the card, frozen as
functions of the configuration's shapes, and the JV kernel's bytes.

Model FLOPs count the products of the convolutions and the matmuls (2 per
multiply-add), nothing elementwise:

* forward: every convolution of the ResNet-50 trunk (its output size from
  the image's by the strides and paddings), the input projection, the
  encoder (the in-projection of q and k from tokens plus positions and of
  v, scores, weighted values, output projection, the MLP), the decoder
  (self-attention over the queries, cross-attention onto the tokens with
  the keys' and values' projections, the MLP) and the heads on every level;
* backward: twice the forward's products for every trained operation (the
  gradient of its input and of its weight), once for one whose input takes
  no gradient (``layer2``'s first block reads the frozen ``layer1``), none
  for the frozen stem and ``layer1``, which run forward only.

JV reads each level's and image's ``[Q, Q]`` f32 cost once and writes its
``[Q]`` int64 assignment once.

One H100 SXM (NVIDIA's data sheet, dense rates, at 700 W): 495 TFLOP/s in
TF32 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
C5 = 2048
HEAD_OUTPUTS = 2 + 4 + 1 + 8       # class (with no-object), 2D box, confidence, 3D box


def conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def backbone_macs(height: int, width: int) -> dict:
    """Multiply-adds of one image through the trunk, split into the frozen
    part, the trained convolutions whose input takes a gradient and those
    whose input does not, and the C5 map's size."""
    h, w = conv_out(height, 7, 2, 3), conv_out(width, 7, 2, 3)
    frozen = 64 * 3 * 49 * h * w
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    trained = weight_only = 0
    channels = 64
    for stage, (blocks, width_, stride) in enumerate(STAGES, start=1):
        for block in range(blocks):
            s = stride if block == 0 else 1
            out_channels = 4 * width_
            ho, wo = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
            first = channels * width_ * h * w                   # 1x1 at the input size
            rest = width_ * width_ * 9 * ho * wo + width_ * out_channels * ho * wo
            shortcut = channels * out_channels * ho * wo if block == 0 else 0
            if stage == 1:
                frozen += first + rest + shortcut
            elif stage == 2 and block == 0:
                weight_only += first + shortcut
                trained += rest
            else:
                trained += first + rest + shortcut
            channels, h, w = out_channels, ho, wo
    return {"frozen": frozen, "trained": trained, "weight_only": weight_only, "c5": (h, w)}


def transformer_macs(tokens: int, config: dict) -> int:
    """Multiply-adds of one image through the projection, the encoder, the
    decoder and the heads on every decoder level."""
    c, f, q = config["hidden_dim"], config["mlp_dim"], config["num_queries"]
    t = tokens
    projection = t * C5 * c
    encoder = 4 * t * c * c + 2 * t * t * c + 2 * t * c * f
    decoder = (4 * q * c * c + 2 * q * q * c                                # self-attention
               + 2 * q * c * c + 2 * t * c * c + 2 * q * t * c              # cross-attention
               + 2 * q * c * f)
    heads = config["num_decoder_layers"] * q * c * HEAD_OUTPUTS
    return (projection + config["num_encoder_layers"] * encoder
            + config["num_decoder_layers"] * decoder + heads)


def step_flops(config: dict) -> float:
    """Model FLOPs of one training step of the configuration's batch."""
    height, width = config["image_size"]
    trunk = backbone_macs(height, width)
    h, w = trunk["c5"]
    forward_trunk = trunk["frozen"] + trunk["trained"] + trunk["weight_only"]
    backward_trunk = 2 * trunk["trained"] + trunk["weight_only"]
    macs = forward_trunk + backward_trunk + 3 * transformer_macs(h * w, config)
    return 2.0 * macs * config["batch"]


def jv_bytes(config: dict) -> int:
    """Bytes one JV launch of the step must move: every level's and image's
    cost read and assignment written once."""
    matrices = config["num_decoder_layers"] * config["batch"]
    q = config["num_queries"]
    return matrices * (q * q * 4 + q * 8)
