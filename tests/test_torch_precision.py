"""The port's default precision against the JAX package's.

``OptimizationConfig.kernel_matmul_precision="default"`` (the port) and
``pallas_matmul_precision="default"`` (the JAX package) run every layer
product of the field kernels with both operands rounded to bf16, the
products exact and the sums f32: the TPU's MXU at ``Precision.DEFAULT``.
On the CPU, JAX ignores ``Precision.DEFAULT`` (its products are f32 at any
precision), so the JAX side runs here under an emulation of the MXU: within
each test ``jax.lax.dot_general`` rounds both operands of a DEFAULT call to
bf16 and then multiplies at HIGHEST, and the Pallas kernels run in interpret
mode (``torch_mxu.mxu_default`` and ``interpret``: ``pallas_supported`` and
``INTERPRET`` patched, jit caches cleared around the patch). No file of the
JAX package changes.

Against that: the plain twins at "default" (K1 u, w, grad_x u; K2 as the
pullback of (du, dw, dg) to (loc, half, packed weights), never the
interleaved matrices; K3 u, w, u_dot; K4a-c at F = 2), at N = 4 and at N =
12 (two instance groups; the JAX side pads to 16 with invalid slots, as its
optimizer pads a scene); ``compute_loss`` with its gradients; three
``train_step`` steps (the loop ``optimize_frame`` runs) with
``deterministic=True`` and fixed rays, across the warmup boundary.

The measure: the root mean square of port - JAX over the entries of an
output, relative to the output's scale (max |JAX|, at least 1). An RMS and
not a maximum, because two f32 evaluations in different orders round a few
operands to the other bf16 neighbour (a value within an f32 ulp of a
rounding boundary), which moves one product term by 2^-8 of itself at
isolated entries; the RMS sees the mode's rounding at every entry. Each
tolerance is at least 10x below the gap that the same test measures
between the JAX package's default and its strict ("highest") result: a twin
that forgets a rounding lands near the unrounded side, which
``test_a_twin_that_forgets_a_rounding_fails`` checks. The kernels'
tolerances (TOL) are 2-3.5x above the largest error measured on an x86-64 CPU
over the three cases (u 1.6e-6, w 4.8e-6, grad_x u 1.4e-5, dloc 1.8e-5,
dhalf 1.3e-5, the weights' pullback 8.9e-6, u_dot 1.9e-5, all at N = 12
but grad_x u, at F = 2) and 10-20x below the smallest gap (u 8.5e-5, w
1.6e-4, grad_x u 9.2e-4, dloc 3.9e-4, dhalf 3.5e-4, the weights' pullback
5.9e-4, u_dot 1.1e-3). End to end the gaps are smaller: the loss and most
gradients depend on the field's products only in part, and two
implementations' sample positions differ by f32 ulps, which the encoding's
top frequency turns into flips; those tolerances and their gaps stand
beside them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import frame as jfm, optimize as jopt
from vsrd_tpu.rendering import fused_field as ff, pallas_field as pf
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt
from vsrd_tpu_torch.rendering import fused_field as tff
from vsrd_tpu_torch.utils import convert

from torch_mxu import interpret, mxu_default

torch.set_num_threads(2)
TAU = 0.5
TILE = 32
GAP = 10.0
# rms tolerances relative to scale, per output (see the module docstring)
TOL = {"u": 5e-6, "w": 1.2e-5, "grad": 5e-5, "dloc": 3.5e-5, "dhalf": 3e-5, "dweights": 3e-5,
       "u_dot": 6e-5}


def rms_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2))) / max(float(np.abs(b).max()), 1.0)


def check(port, ref, strict, outputs):
    """Each output of ``port`` within TOL of ``ref`` (the emulated JAX
    default), and ``ref`` at least GAP x TOL from ``strict``."""
    for name in outputs:
        err, gap = rms_rel(port[name], ref[name]), rms_rel(strict[name], ref[name])
        assert err <= TOL[name], (name, err, gap)
        assert gap >= GAP * TOL[name], (name, err, gap)


def _inputs(n, p=64, seed=0, valid=None, frames=None):
    rng = np.random.default_rng(seed)

    def one(_):
        angles = rng.uniform(-1, 1, n)
        dirs = rng.normal(size=(p, 3))
        return dict(
            pos=rng.normal(size=(p, 3)) * 2, loc=rng.normal(size=(n, 3)) * 1.5,
            rot=np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                          for a in angles]),
            half=rng.uniform(0.5, 2.0, size=(n, 3)),
            valid=np.asarray(valid if valid is not None else [1.0] * (n - 1) + [0.0]),
            w=rng.normal(size=(n, 1617)) * 0.3, du=rng.normal(size=p),
            dw=rng.normal(size=(p, n)), dg=rng.normal(size=(p, 3)),
            dirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))

    parts = [one(f) for f in range(frames or 1)]
    x = parts[0] if frames is None else {k: np.stack([q[k] for q in parts]) for k in parts[0]}
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def _padded(x, n_jax):
    """The JAX side's scene: N padded to ``n_jax`` with invalid slots."""
    n = x["loc"].shape[-2]
    if n == n_jax:
        return x
    pad = n_jax - n
    out = dict(x)
    lead = x["loc"].shape[:-2]
    for k, fill in (("loc", 0.0), ("half", 1.0), ("w", 0.0)):
        out[k] = np.concatenate([x[k], np.full((*lead, pad, x[k].shape[-1]), fill, np.float32)],
                                -2)
    out["rot"] = np.concatenate([x["rot"], np.broadcast_to(np.eye(3, dtype=np.float32),
                                                           (*lead, pad, 3, 3))], -3)
    out["valid"] = np.concatenate([x["valid"], np.zeros((*lead, pad), np.float32)], -1)
    out["dw"] = np.concatenate([x["dw"], np.zeros((*x["dw"].shape[:-1], pad), np.float32)], -1)
    return out


def _jax_field(x, precision, n_jax):
    """The JAX kernels (K1 forward, K2 through its custom VJP, K3), one
    frame or F frames: u, w, grad, the pullbacks, u_dot; w and the
    pullbacks cut back to the port's N."""
    n = x["loc"].shape[-2]
    j = {k: jnp.asarray(v) for k, v in _padded(x, n_jax).items()}
    statics = ff.FieldStatics(num_instances=n_jax, field_dtype=None, matmul_precision=precision,
                              rev_grad=True)
    build = (jax.vmap(ff.build_interleaved_layers) if x["pos"].ndim == 3
             else ff.build_interleaved_layers)

    def loss(loc, half, w):
        u, wts, g = pf.fused_field_with_grad(statics, TILE, j["pos"], loc, j["rot"], half,
                                             j["valid"], build(w), TAU)
        return jnp.sum(u * j["du"]) + jnp.sum(wts * j["dw"]) + jnp.sum(g * j["dg"]), (u, wts, g)

    (_, (u, wts, g)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        j["loc"], j["half"], j["w"])
    _, _, u_dot = pf.fused_field_dir_forward(statics, TILE, j["pos"], j["dirs"], j["loc"],
                                             j["rot"], j["half"], j["valid"], build(j["w"]), TAU)
    out = dict(u=u, w=wts[..., :n], grad=g, dloc=grads[0][..., :n, :],
               dhalf=grads[1][..., :n, :], dweights=grads[2][..., :n, :], u_dot=u_dot)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_field(x, precision="default", directional=True):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    batched = x["pos"].ndim == 3
    params = [t[k].clone().requires_grad_() for k in ("loc", "half", "w")]
    fn = tff.scene_eval_with_grad_batched if batched else tff.scene_eval_with_grad
    u, w, g = fn(t["pos"], params[0], t["rot"], params[1], t["valid"], params[2],
                 torch.tensor(TAU), precision=precision)
    loss = (u * t["du"]).sum() + (w * t["dw"]).sum() + (g * t["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    out = dict(u=u, w=w, grad=g, dloc=grads[0], dhalf=grads[1], dweights=grads[2])
    if directional:
        dir_fn = tff.scene_eval_dir_batched if batched else tff.scene_eval_dir
        _, _, out["u_dot"] = dir_fn(t["pos"], t["dirs"], t["loc"], t["rot"], t["half"],
                                    t["valid"], t["w"], torch.tensor(TAU), precision=precision)
    return {k: v.detach().numpy() for k, v in out.items()}


CASES = {"N=4": (4, 4, None), "N=12": (12, 16, None), "F=2": (4, 4, 2)}


@pytest.fixture(scope="module")
def references():
    """The JAX kernels at the emulated default and at "highest", per case."""
    out = {}
    with interpret():
        for case, (n, n_jax, frames) in CASES.items():
            x = _inputs(n, seed=len(out), frames=frames)
            with mxu_default():
                default = _jax_field(x, "default", n_jax)
            out[case] = (x, default, _jax_field(x, "highest", n_jax))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_k1_k2_twins_match_the_jax_kernels_at_default(references, case):
    """K1 (u, w, grad_x u) and K2's pullback (K4a/K4c at F = 2)."""
    x, default, strict = references[case]
    check(_port_field(x), default, strict, ("u", "w", "grad", "dloc", "dhalf", "dweights"))


@pytest.mark.parametrize("case", list(CASES))
def test_k3_twin_matches_the_jax_kernel_at_default(references, case):
    """K3 (K4b at F = 2): u_dot, the tangent rounded where it enters each product."""
    x, default, strict = references[case]
    check(_port_field(x), default, strict, ("u_dot",))


@pytest.mark.parametrize("mutant", ["bias", "layer 2", "cotangent"])
def test_a_twin_that_forgets_a_rounding_fails(references, monkeypatch, mutant):
    """The K1/K2 comparison with one rounding left out of the twin: the bias
    column, every product of one layer, or the backward's rounding of the
    incoming cotangent. Each breaks a tolerance."""
    x, default, strict = references["N=4"]
    rounded = tff.bf16_round
    calls = {"n": 0}

    class Mutant(torch.autograd.Function):
        @staticmethod
        def forward(a, b):
            if mutant == "bias":    # the bias row of b (the last) unrounded
                return rounded(a) @ torch.cat([rounded(b[..., :-1, :]), b[..., -1:, :]], -2)
            return rounded(a) @ rounded(b)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        @staticmethod
        def backward(ctx, grad):
            a, b = ctx.saved_tensors
            if mutant == "cotangent":
                return grad @ rounded(b).mT, rounded(a).mT @ grad
            return mutated(grad, b.mT), mutated(a.mT, grad)

    def mutated(a, b):
        calls["n"] += 1
        if mutant == "layer 2" and calls["n"] % 5 == 3:   # the third of the five layers
            return a @ b
        return Mutant.apply(a, b)

    monkeypatch.setattr(tff, "bf16_matmul", mutated)
    port = _port_field(x, directional=False)
    errors = {k: rms_rel(port[k], default[k]) / TOL[k] for k in ("u", "grad", "dweights")}
    assert max(errors.values()) > 1.0, errors


# ------------------------------------------------- compute_loss and train_step

RAYS, SAMPLES = 16, 6
CFG = dict(num_steps=20, warmup_steps=2, num_rays=RAYS, num_samples=SAMPLES, deterministic=True,
           checkpoint_interval=3, metric_interval=2)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="default", pallas_tile=TILE,
                               pallas_bwd_tile=TILE, pallas_box_tile=TILE, **CFG)
JCFG_HIGHEST = dataclasses.replace(JCFG, pallas_matmul_precision="highest")
TCFG = topt.OptimizationConfig(**CFG)
assert TCFG.kernel_matmul_precision == "default"


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    kw = dict(num_views=2, image_size=(32, 48), num_instances=3, max_instances=4)
    jf = jfm.synthetic_frame(key, **kw)
    tf = tfm.synthetic_frame(seed, **kw, device="cpu")
    params = jopt.init_params(jax.random.PRNGKey(1), 4, JCFG)
    rng = np.random.default_rng(0)
    params["boxes"]["locations"] = jnp.asarray(
        rng.normal(size=(4, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, -1.5]))
    params["boxes"]["embeddings"] = jnp.asarray(rng.normal(size=(4, 256)).astype(np.float32))
    ray_idx = np.asarray(jf.candidate_indices)[rng.choice(1000, RAYS, replace=False)]
    return jf, tf, jax.device_get(params), ray_idx


def _pooled(got, ref):
    """The RMS over a tree's leaves of each leaf's RMS error relative to
    its scale."""
    return float(np.sqrt(np.mean([rms_rel(got[path], ref[path]) ** 2 for path in ref])))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# compute_loss at step 5 (residual): relative errors of the loss and its
# terms that the field's products move, and the pooled RMS of the gradients
# (measured on an x86-64 CPU: total 1.5e-7, silhouette 8.0e-7, eikonal
# 2.4e-5, gradients 4.7e-6; the default-vs-highest gaps 1.7e-5, 8.5e-5,
# 1.6e-1 and 9.9e-5)
TOL_LOSS = {"total": 1e-6, "silhouette_loss": 5e-6, "eikonal_loss": 1e-4}
TOL_GRAD = 9e-6


def test_compute_loss_and_gradients_match_jax_at_default(setup):
    """The residual phase (step 5): the loss, its silhouette and eikonal
    terms and every parameter's gradient against the JAX package's at the
    emulated default, each tolerance at least GAP x below the same value's
    gap to the JAX package's "highest". The projection terms take no field
    product (they read the boxes alone) and are equal in both modes: they
    are held to the f32 bar of ``test_torch_optimize.py`` (1e-5)."""
    jf, tf, params, ray_idx = setup

    def jax_loss(cfg):
        def f(p):
            return jopt.compute_loss(p, jf, jnp.asarray(5), jax.random.PRNGKey(2), cfg, True,
                                     ray_indices=jnp.asarray(ray_idx, jnp.int32))

        (total, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        leaves = dict(topt.tree_leaves(convert.params_from_jax(jax.device_get(grads),
                                                               device="cpu")))
        losses = {k: float(v) for k, v in aux["losses"].items()}
        return dict(losses, total=float(total)), {k: v.numpy() for k, v in leaves.items()}

    with interpret():
        with mxu_default():
            losses, grads = jax_loss(JCFG)
        strict_losses, strict_grads = jax_loss(JCFG_HIGHEST)
    tp = convert.params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(tp)]
    total, aux = topt.compute_loss(tp, tf, 5, TCFG, True, ray_indices=torch.as_tensor(ray_idx))
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    got = {path: g.numpy() for (path, _), g in zip(topt.tree_leaves(tp), got)}
    port = {k: float(v.detach()) for k, v in aux["losses"].items()}
    port["total"] = float(total.detach())
    for name, tol in TOL_LOSS.items():
        err, gap = _rel(port[name], losses[name]), _rel(strict_losses[name], losses[name])
        assert err <= tol and gap >= GAP * tol, (name, err, gap)
    for name in ("l1_projection_loss", "iou_projection_loss"):
        np.testing.assert_allclose(port[name], losses[name], rtol=1e-5, err_msg=name)
    err, gap = _pooled(got, grads), _pooled(strict_grads, grads)
    assert err <= TOL_GRAD and gap >= GAP * TOL_GRAD, (err, gap)


# the three steps: step 2's loss, silhouette and eikonal terms (measured on
# an x86-64 CPU: 2.4e-7, 3.2e-7, 1.7e-4; gaps 7.6e-6, 7.0e-5, 6.7e-2) and
# the pooled RMS of the updates (1.5e-7; gap 1.0e-5)
TOL_STEP = {"loss": 7e-7, "silhouette_loss": 1e-6, "eikonal_loss": 5e-4}
TOL_UPDATE = 9e-7


def test_three_steps_match_jax_at_default(setup):
    """``train_step`` (the step ``optimize_frame`` runs) three times from
    the same params, deterministic, on fixed rays: steps 0-1 box-only (no
    field product: every scalar at the f32 bar of ``test_torch_optimize.py``
    in both modes), step 2 the first with the residual field (its loss
    terms at TOL_STEP), then the three steps' updates of every parameter
    (TOL_UPDATE), each tolerance at least GAP x below its gap to the JAX
    package's "highest"."""
    jf, tf, params, ray_idx = setup

    def jax_steps(cfg):
        tx = jopt.make_optimizer(cfg, params)
        state = tx.init(params)
        step_fn = jax.jit(jopt.train_step, static_argnames=("cfg", "tx"))
        p, scalars = params, []
        for step in range(3):
            p, state, s = step_fn(p, state, jf, jnp.asarray(step), jax.random.PRNGKey(step),
                                  cfg, tx, ray_indices=jnp.asarray(ray_idx, jnp.int32))
            scalars.append({k: float(v) for k, v in s.items()})
        return scalars, {k: v.numpy() for k, v in topt.tree_leaves(
            convert.params_from_jax(jax.device_get(p), device="cpu"))}

    with interpret():
        with mxu_default():
            scalars, after = jax_steps(JCFG)
        strict_scalars, strict_after = jax_steps(JCFG_HIGHEST)
    tp = convert.params_from_jax(params, device="cpu")
    before = {path: v.numpy().copy() for path, v in topt.tree_leaves(tp)}
    state = convert.adam_state_from_jax(jax.device_get(
        jopt.make_optimizer(JCFG, params).init(params)), device="cpu")
    optimizer = topt.Adam(TCFG)
    for step in range(3):
        s = topt.train_step(tp, state, tf, step, TCFG, optimizer,
                            ray_indices=torch.as_tensor(ray_idx))
        for name in ("loss", "silhouette_loss", "eikonal_loss", "iou_3d", "num_matched"):
            got, want = float(s[name]), scalars[step][name]
            if step < 2 or name not in TOL_STEP:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8,
                                           err_msg=f"{name} @ {step}")
                continue
            err, gap = _rel(got, want), _rel(strict_scalars[step][name], want)
            assert err <= TOL_STEP[name] and gap >= GAP * TOL_STEP[name], (name, err, gap)
    moved = {path: v.numpy() - before[path] for path, v in topt.tree_leaves(tp)}
    want = {path: after[path] - before[path] for path in moved}
    strict = {path: strict_after[path] - before[path] for path in moved}
    err, gap = _pooled(moved, want), _pooled(strict, want)
    assert err <= TOL_UPDATE and gap >= GAP * TOL_UPDATE, (err, gap)
