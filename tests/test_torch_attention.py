"""The port's attention modules (``vsrd_tpu_torch/modules/attention.py``)
against the flax modules of ``vsrd_tpu/modules/attention.py`` on the same
numpy inputs, with the flax weights carried across by
``convert.detector_params_from_jax`` (the modules keep flax's ``Dense_i``
names). All three scale the logits by 1/sqrt(out_channels), the whole
width. Tolerance: 1e-5 relative to the output's scale (f32 sums in another
order)."""

import jax
import numpy as np
import pytest
import torch

from vsrd_tpu.modules import attention as jatt
from vsrd_tpu_torch.modules import attention as tatt
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)
TOL = 1e-5


def _carry(jmodule, tmodule, *inputs):
    params = jax.device_get(jmodule.init(jax.random.PRNGKey(0), *inputs))
    # the biases start at 0 in flax: give them values so that they count
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda p: (np.asarray(p) + rng.normal(scale=0.1, size=p.shape)
                                     ).astype(np.float32), params)
    tmodule.load_state_dict(convert.detector_params_from_jax(params, "cpu"))
    want = np.asarray(jmodule.apply(params, *inputs))
    with torch.no_grad():
        got = tmodule(*[torch.from_numpy(x) for x in inputs]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("kernel_size, stride, dilation", [(3, 1, 1), (3, 2, 1), (5, 1, 2)])
def test_local_attention_matches_flax(kernel_size, stride, dilation):
    rng = np.random.default_rng(kernel_size + stride + dilation)
    q, k, v = (rng.normal(size=(2, 7, 9, 6)).astype(np.float32) for _ in range(3))
    _carry(jatt.MultiHeadLocalAttention2d(8, kernel_size, stride, dilation, num_heads=2),
           tatt.MultiHeadLocalAttention2d(6, 8, kernel_size, stride, dilation, num_heads=2),
           q, k, v)


def test_global_attention_matches_flax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    k, v = (rng.normal(size=(2, 5, 2, 6)).astype(np.float32) for _ in range(2))
    _carry(jatt.MultiHeadGlobalAttention2d(8, num_heads=4),
           tatt.MultiHeadGlobalAttention2d(6, 8, num_heads=4), q, k, v)


def test_deformable_attention_matches_flax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 5, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 6, 7, 8)).astype(np.float32) for _ in range(2))
    _carry(jatt.MultiHeadDeformableAttention(8, num_samples=4, num_heads=2),
           tatt.MultiHeadDeformableAttention(8, 8, num_samples=4, num_heads=2), q, k, v)
