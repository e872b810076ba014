"""The plain twins of the port's field kernels K1-K3 against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

Inputs: N=4 instances (the last invalid), 96 points, f32 weights from a
numpy seed; the JAX kernels in strict mode (matmul precision 'highest').

Tolerances, with their reasons:
* u and w: 2e-6 absolute (+ 2e-7 relative, one f32 ulp of a ~10 m
  distance): the same f32 arithmetic in another order;
* grad_x u: 1e-5 absolute: the JAX kernel's GELU uses a rational erf
  (max error 1.5e-7) where the port uses the exact one, and the LayerNorm
  Jacobian amplifies it;
* the pullback of (du, dw, dg) to loc, rot, half and the flat weights:
  1e-4 relative to the reference's own scale (bench.py's err()): these
  are sums over all points.

The CUDA kernels themselves are held against these twins in
``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.rendering import fused_field as ff
from vsrd_tpu.rendering import pallas_field as pf
from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import fused_field as tff

torch.set_num_threads(2)
TAU = 0.5


def _inputs(n=4, p=96, seed=0, valid=(1.0, 1.0, 1.0, 0.0)):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(p, 3)) * 5).astype(np.float32)
    loc = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    angles = rng.uniform(-1, 1, n)
    rot = np.stack([
        np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
        for a in angles
    ])
    half = rng.uniform(0.5, 2.0, size=(n, 3)).astype(np.float32)
    w = (rng.normal(size=(n, 1617)) * 0.3).astype(np.float32)
    dirs = rng.normal(size=(p, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cot = dict(du=rng.normal(size=p), dw=rng.normal(size=(p, n)), dg=rng.normal(size=(p, 3)))
    return dict(pos=pos, loc=loc, rot=rot, half=half, valid=np.asarray(valid, np.float32),
                w=w, dirs=dirs, **{k: v.astype(np.float32) for k, v in cot.items()})


def _statics(n, use_rdf):
    return ff.FieldStatics(num_instances=n, use_rdf=use_rdf, field_dtype=None,
                           matmul_precision="highest")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pf, "INTERPRET", True)


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("valid", [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_k1_twin_matches_pallas_forward(interpret, use_rdf, valid):
    x = _inputs(valid=valid)
    n = len(valid)
    mats = ff.build_interleaved_layers(jnp.asarray(x["w"])) if use_rdf else ()
    u, w, g = pf.fused_field_with_grad(
        _statics(n, use_rdf), 32, jnp.asarray(x["pos"]), x["loc"], x["rot"], x["half"],
        x["valid"], mats, TAU)
    u2, w2, g2 = tff.scene_eval_with_grad(
        _t(x["pos"]), _t(x["loc"]), _t(x["rot"]), _t(x["half"]), _t(x["valid"]),
        _t(x["w"]) if use_rdf else None, torch.tensor(TAU))
    u2, w2, g2 = u2.detach(), w2.detach(), g2.detach()
    np.testing.assert_allclose(u2.numpy(), np.asarray(u), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g), atol=1e-5)
    if not any(valid):
        # no valid instance: uniform weights, as the f32 logit mask gives
        np.testing.assert_allclose(w2.numpy(), 1.0 / n, rtol=1e-6)


@pytest.mark.parametrize("use_rdf", [False, True])
def test_k2_twin_pullback_matches_pallas_custom_vjp(interpret, use_rdf):
    x = _inputs(seed=1)
    n = 4
    statics = _statics(n, use_rdf)

    def jax_field(loc, rot, half, w):
        mats = ff.build_interleaved_layers(w) if use_rdf else ()
        return pf.fused_field_with_grad(statics, 32, jnp.asarray(x["pos"]), loc, rot, half,
                                        x["valid"], mats, TAU)

    _, vjp = jax.vjp(jax_field, *(jnp.asarray(x[k]) for k in ("loc", "rot", "half", "w")))
    ref = vjp((jnp.asarray(x["du"]), jnp.asarray(x["dw"]), jnp.asarray(x["dg"])))

    params = [_t(x[k]).requires_grad_() for k in ("loc", "rot", "half", "w")]
    u, w, g = tff.scene_eval_with_grad(_t(x["pos"]), *params[:3], _t(x["valid"]),
                                       params[3] if use_rdf else None, torch.tensor(TAU))
    loss = (u * _t(x["du"])).sum() + (w * _t(x["dw"])).sum() + (g * _t(x["dg"])).sum()
    got = torch.autograd.grad(loss, params if use_rdf else params[:3])
    for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), got, ref):
        assert _err(a.numpy(), b) <= 1e-4, name


def test_k3_twin_matches_pallas_dir_forward(interpret):
    """Box-only, as the main path's coarse pass runs it: u and w as K1's,
    u_dot = <dir, grad_x u>."""
    x = _inputs(seed=2)
    statics = _statics(4, False)
    u, w, ud = pf.fused_field_dir_forward(statics, 32, jnp.asarray(x["pos"]),
                                          jnp.asarray(x["dirs"]), x["loc"], x["rot"],
                                          x["half"], x["valid"], (), TAU)
    _, _, g = pf.fused_field_with_grad(statics, 32, jnp.asarray(x["pos"]), x["loc"], x["rot"],
                                       x["half"], x["valid"], (), TAU)
    args = [_t(x[k]) for k in ("pos", "dirs", "loc", "rot", "half", "valid")]
    u2, w2, ud2 = tff.scene_eval_dir(*args, None, torch.tensor(TAU))
    np.testing.assert_allclose(u2.numpy(), np.asarray(u), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(ud2.numpy(), np.asarray(ud), atol=1e-5)
    np.testing.assert_allclose(ud2.numpy(), np.sum(np.asarray(g) * x["dirs"], -1), atol=1e-5)


def test_k3_twin_with_residual_field_is_the_directional_derivative():
    x = _inputs(seed=3)
    args = [_t(x[k]) for k in ("loc", "rot", "half", "valid", "w")]
    _, _, g = tff.scene_eval_with_grad(_t(x["pos"]), *args, torch.tensor(TAU))
    _, _, ud = tff.scene_eval_dir(_t(x["pos"]), _t(x["dirs"]), *args, torch.tensor(TAU))
    np.testing.assert_allclose(ud.numpy(), (g * _t(x["dirs"])).sum(-1).detach().numpy(),
                               atol=1e-5)


def test_cpu_tensors_take_the_twins_and_launchers_refuse_them():
    x = _inputs()
    args = [_t(x[k]) for k in ("pos", "loc", "rot", "half", "valid", "w")]
    a = fk.fused_field_with_grad(*args, torch.tensor(TAU))
    b = tff.scene_eval_with_grad(*args, torch.tensor(TAU))
    for s, t in zip(a, b):
        torch.testing.assert_close(s, t, rtol=0, atol=0)
    before = fk.field_forward.launches
    with pytest.raises(ValueError):
        fk.field_forward(*args, torch.tensor(TAU))
    with pytest.raises(ValueError):
        fk.field_dir_forward(args[0], _t(x["dirs"]), *args[1:], torch.tensor(TAU))
    assert fk.field_forward.launches == before
