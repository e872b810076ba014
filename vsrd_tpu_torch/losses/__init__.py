"""Losses of the library (the optimization step's own are in
``pipeline/optimize.py``); the exports of ``vsrd_tpu/losses/__init__.py``."""

from . import classification, geometric, photometric, probabilistic, smoothness, utils
from .classification import (
    binary_cross_entropy,
    binary_js_divergence,
    binary_kl_divergence,
    cross_entropy,
    focal_loss,
    focal_tversky_loss,
    js_divergence,
    kl_divergence,
    quality_focal_loss,
    tversky_loss,
)
from .geometric import (
    rotation_consistency_loss,
    sampson_epipolar_distance,
    translation_consistency_loss,
)
from .photometric import photometric_loss, ssim_loss
from .probabilistic import (
    gaussian_energy_score,
    gaussian_nll,
    logit_gaussian_nll,
    logit_student_nll,
    student_energy_score,
    student_nll,
)
from .smoothness import motion_smoothness_loss, motion_sparsity_loss, smoothness_loss
from .utils import reduced
