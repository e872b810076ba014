"""The port's hypernetwork and per-instance layer split against the JAX
package's, from converted parameters.

Tolerance: 1e-6 relative to the output scale — four 256-wide f32
products with LayerNorm, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vsrd_tpu.models import hyper_field as jhf
from vsrd_tpu.rendering import fused_field as jff
from vsrd_tpu_torch.models import hyper_field as thf
from vsrd_tpu_torch.rendering import fused_field as tff
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)


def test_field_layer_sizes_match():
    assert thf.field_layer_sizes(48, (16, 16, 16, 16)) == jhf.field_layer_sizes(48, (16, 16, 16, 16))
    assert sum(thf.field_layer_sizes(48, (16,) * 4)[1]) == 1617


def test_hypernetwork_apply_matches_converted_params():
    params = jhf.init_hyper_field(jax.random.PRNGKey(3))
    emb = np.random.default_rng(0).normal(size=(4, 256)).astype(np.float32)
    ref = np.asarray(jhf.hypernetwork_apply(params, jnp.asarray(emb)))
    tp = {"layers": convert.to_torch_tree(list(jax.device_get(params)["layers"]), device="cpu")}
    got = thf.hypernetwork_apply(tp, torch.from_numpy(emb)).numpy()
    assert got.shape == (4, 1617)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_init_hyper_field_structure():
    gen = torch.Generator().manual_seed(0)
    tp = thf.init_hyper_field(gen)
    jp = jhf.init_hyper_field(jax.random.PRNGKey(0))
    assert len(tp["layers"]) == len(jp["layers"])
    for a, b in zip(tp["layers"], jp["layers"]):
        assert sorted(a) == sorted(b)
        for key in a:
            assert tuple(a[key].shape) == b[key].shape, key
        # nn.Linear's init bound and the weight-norm gain at ||v||
        bound = 1.0 / np.sqrt(a["v"].shape[1])
        assert float(a["v"].abs().max()) <= bound
        torch.testing.assert_close(a["g"], torch.linalg.vector_norm(a["v"], dim=-1))


def test_split_field_layers_and_permutation_match():
    w = np.random.default_rng(1).normal(size=(3, 1617)).astype(np.float32)
    ref = jff.split_field_layers(jnp.asarray(w))
    got = tff.split_field_layers(torch.from_numpy(w))
    assert tff.enc_permutation() == jff.enc_permutation()
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
