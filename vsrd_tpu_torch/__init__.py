"""VSRD auto-labeling in PyTorch with hand-written CUDA kernels for Hopper.

The counterpart of ``vsrd_tpu`` (JAX on a TPU): the same subpackage and
module names, the same math, plain PyTorch around three hand-written CUDA
kernels (``rendering/field_kernels.py``, ``csrc/``). This package never
imports JAX or ``vsrd_tpu``; only the tests bridge the two.

Numeric policy (the counterpart of ``vsrd_tpu/__init__.py``): float32
matrix products and convolutions run in full float32. TF32 keeps about
three decimal digits, and at the 100 m coordinates of a street scene that
moves a ray by about 0.4 px.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
