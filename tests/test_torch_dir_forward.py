"""K3/K4b's per-point math against the JAX package's directional forward.

The per-point math of K3 (``csrc/field_common.cuh``: ``instance_dir`` with
its layer products as scalar loops, ``box_dir`` box-only, and the union
``dir_union``, compiled for the host as in ``test_torch_kernels.py``)
against ``fused_field.scene_eval_stacked_dir_t`` of the JAX package in
strict mode (``field_dtype=None``, 'highest' matmuls) on the same numpy
inputs. Tolerances: u and w 1e-6 absolute (+ 2e-7 relative, since two
packages sum in different orders and a distance of 8 m has an f32 spacing
of 9.5e-7); u_dot 1e-4 absolute with the residual field, whose tangent goes
through four LayerNorm Jacobians, and 1e-5 box-only.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_kernels import _host_dir_forward, _inputs, host_lib  # noqa: F401
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
def test_host_dir_forward_math_matches_the_jax_directional_forward(host_lib, use_rdf, n,
                                                                   valid):
    x = _inputs(n=n, seed=8, valid=valid)
    u, w, ud = _host_dir_forward(host_lib, x, use_rdf)
    statics = jff.FieldStatics(num_instances=n, field_dtype=None, use_rdf=use_rdf)
    mats = jff.build_interleaved_layers(jnp.asarray(x["w"])) if use_rdf else ()
    u2, w2, ud2 = jff.scene_eval_stacked_dir_t(
        jnp.asarray(x["pos"]).T, jnp.asarray(x["dirs"]).T,
        *(jnp.asarray(x[k]) for k in ("loc", "rot", "half")),
        jnp.asarray(x["valid"])[:, None], mats, TAU, statics)
    np.testing.assert_allclose(u, np.asarray(u2)[0], atol=1e-6, rtol=2e-7)
    np.testing.assert_allclose(w, np.asarray(w2).T, atol=1e-6, rtol=2e-7)
    np.testing.assert_allclose(ud, np.asarray(ud2)[0], atol=1e-4 if use_rdf else 1e-5)
