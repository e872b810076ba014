"""Network modules: attention, blocks, Sinkhorn-Knopp, plane-sweep stereo."""

from . import attention, blocks, sinkhorn, stereo
from .attention import (
    MultiHeadDeformableAttention,
    MultiHeadGlobalAttention2d,
    MultiHeadLocalAttention2d,
)
from .blocks import (
    DropPath,
    LayerScale,
    PackingBlock,
    Residual,
    Scale,
    Sequential,
    SqueezeExcitation,
    UnpackingBlock,
    grad_scale,
    pixel_shuffle,
    pixel_unshuffle,
)
from .sinkhorn import sinkhorn_knopp
from .stereo import PlaneSweepStereo, SpatialPropagation2d
