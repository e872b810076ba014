"""The TPU's ``Precision.DEFAULT`` for the JAX package on the CPU, for the
port's tests of its default precision.

On the CPU, JAX computes an f32 ``dot_general`` in f32 at any precision;
the TPU's MXU at ``Precision.DEFAULT`` rounds both operands to bf16 (to
nearest even), forms exact products and sums them in f32. ``mxu_default``
makes every DEFAULT call of ``jax.lax.dot_general`` do that (the operands
rounded, then multiplied at HIGHEST), and ``interpret`` runs the Pallas
kernels in interpret mode, so that the JAX package takes its kernel path on
the CPU. ``port_unrounded`` leaves the bf16 rounding out of the port's
plain twins, so that the port's default mode computes what the JAX
package's does on the CPU without ``mxu_default``: the default mode's
control flow and encoding with f32 products. Each patches attributes only
for the ``with`` block (jit caches cleared on entry and exit of
``mxu_default``); no file of the JAX package changes.
"""

import contextlib

import jax
import jax.numpy as jnp
import pytest

from vsrd_tpu.rendering import pallas_field as pf
from vsrd_tpu_torch.rendering import fused_field as tff


@contextlib.contextmanager
def mxu_default():
    """``jax.lax.dot_general`` at ``Precision.DEFAULT`` as the TPU computes it."""
    original = jax.lax.dot_general

    def emulated(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                 **kwargs):
        if precision == jax.lax.Precision.DEFAULT:
            lhs, rhs = (t.astype(jnp.bfloat16).astype(t.dtype) for t in (lhs, rhs))
            precision = jax.lax.Precision.HIGHEST
        return original(lhs, rhs, dimension_numbers, precision=precision,
                        preferred_element_type=preferred_element_type, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "dot_general", emulated)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


@contextlib.contextmanager
def interpret():
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "INTERPRET", True)
        mp.setattr(pf, "pallas_supported", lambda: True)
        yield


@contextlib.contextmanager
def port_unrounded():
    """The port's twins at "default" without the bf16 rounding."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tff, "bf16_round", lambda x: x)
        yield
