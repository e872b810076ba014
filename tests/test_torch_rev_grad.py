"""K1/K4a's reverse sweep against the JAX package's reverse form.

The per-point math of K1 (``csrc/field_common.cuh``, ``instance_rev``,
compiled for the host with scalar layer products as in
``test_torch_kernels.py``) against ``fused_field.scene_eval_stacked`` of
the JAX package with ``rev_grad=True`` (its ``_scene_eval_stacked_rev``) on
the same numpy inputs, at the tolerances that the JAX package's own test of
its reverse form uses (``tests/test_fused_field.py``,
``test_stacked_rev_grad_matches_tangent``): u and w 1e-6 absolute, grad_x u
1e-4 absolute with the residual field and 1e-5 box-only; u and w also 2e-7
relative, since two packages sum in different orders and a distance of 8 m
has an f32 spacing of 9.5e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_kernels import _host_forward_rev, _inputs, host_lib  # noqa: F401
from vsrd_tpu.rendering import fused_field as jff

TAU = 0.5


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n, valid", [
    (4, (1.0, 1.0, 1.0, 0.0)),
    (4, (0.0, 0.0, 0.0, 0.0)),     # no valid instance: the uniform union
    (3, (0.0, 1.0, 0.0)),          # one valid instance: its weight is 1
    (8, (1.0,) * 6 + (0.0,) * 2),  # the main path's N and validity, one JAX group
    (16, (1.0,) * 15 + (0.0,)),    # two of the JAX package's groups of 8
])
def test_host_rev_forward_math_matches_the_jax_reverse_form(host_lib, use_rdf, n, valid):
    x = _inputs(n=n, seed=7, valid=valid)
    u, w, g = _host_forward_rev(host_lib, x, use_rdf)
    statics = jff.FieldStatics(num_instances=n, field_dtype=None, rev_grad=True,
                               use_rdf=use_rdf)
    mats = jff.build_interleaved_layers(jnp.asarray(x["w"])) if use_rdf else ()
    u2, w2, g2 = jff.scene_eval_stacked(*(jnp.asarray(x[k]) for k in
                                          ("pos", "loc", "rot", "half", "valid")),
                                        mats, TAU, statics)
    np.testing.assert_allclose(u, np.asarray(u2), atol=1e-6, rtol=2e-7)
    np.testing.assert_allclose(w, np.asarray(w2), atol=1e-6, rtol=2e-7)
    np.testing.assert_allclose(g, np.asarray(g2), atol=1e-4 if use_rdf else 1e-5)
