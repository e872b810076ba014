"""The port's single-frame optimization step against the JAX package's.

Both packages run in strict mode (field in f32, matmul precision
'highest') on the same synthetic frame, parameters (converted from the
JAX pytree) and fixed ray indices.

The samplers draw their stratified and importance uniforms from noise
that this module hands to both packages (``jax.random.uniform`` and the
port's ``samplers._uniform`` are patched for the [rays, samples] draws).
Deterministic mode is not used here: its last importance sample sits at
u = 1 exactly, whose CDF bracket is decided by whether a rounding-level
opacity is 0 or 1e-8, so two correct implementations can put that sample
a bin apart; uniform draws land there with probability ~1e-7.

Tolerances: loss terms 1e-5 relative; gradients 1e-4 relative to each
parameter's gradient scale (f32 sums over rays, samples and the 256-wide
hypernetwork in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import frame as jfm, optimize as jopt
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt
from vsrd_tpu_torch.rendering import field_kernels, samplers as tsamplers
from vsrd_tpu_torch.utils import convert

from torch_mxu import interpret, port_unrounded

torch.set_num_threads(2)

RAYS, SAMPLES = 16, 6
CFG = dict(num_steps=20, warmup_steps=2, num_rays=RAYS, num_samples=SAMPLES,
           deterministic=False, checkpoint_interval=3, metric_interval=2)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
NOISE = np.random.default_rng(7).random((2, RAYS, SAMPLES)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    kw = dict(num_views=2, image_size=(32, 48), num_instances=3, max_instances=4)
    jf = jfm.synthetic_frame(key, **kw)
    tf = tfm.synthetic_frame(seed, **kw, device="cpu")
    params = jopt.init_params(jax.random.PRNGKey(1), 4, JCFG)
    rng = np.random.default_rng(0)
    # boxes that see the scene, embeddings that differ per instance
    params["boxes"]["locations"] = jnp.asarray(
        rng.normal(size=(4, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, -1.5]))
    params["boxes"]["embeddings"] = jnp.asarray(rng.normal(size=(4, 256)).astype(np.float32))
    ray_idx = np.asarray(jf.candidate_indices)[rng.choice(1000, RAYS, replace=False)]
    return jf, tf, jax.device_get(params), ray_idx


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages' [rays, samples] uniforms come from NOISE, alternating
    coarse (quadrature) and fine (importance) draws in call order."""
    calls = {"jax": 0, "torch": 0}
    jax_uniform = jax.random.uniform

    def fake_jax(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        if tuple(shape) != (RAYS, SAMPLES):
            return jax_uniform(key, shape, dtype, *args, **kwargs)
        calls["jax"] += 1
        return jnp.asarray(NOISE[(calls["jax"] - 1) % 2], dtype)

    def fake_torch(shape, generator, like):
        assert tuple(shape) == (RAYS, SAMPLES)
        calls["torch"] += 1
        return torch.from_numpy(NOISE[(calls["torch"] - 1) % 2]).to(like.dtype)

    monkeypatch.setattr(jax.random, "uniform", fake_jax)
    monkeypatch.setattr(tsamplers, "_uniform", fake_torch)
    return calls


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else float(np.abs(a).max())


@pytest.mark.parametrize("use_rdf", [False, True])
def test_compute_loss_and_gradients_match(setup, shared_noise, use_rdf):
    _compare_loss_and_gradients(setup, TCFG, use_rdf)


@pytest.mark.parametrize("use_rdf", [False, True])
def test_compute_loss_with_the_step_on_the_device_matches(setup, shared_noise, use_rdf):
    """The step index as the float32 tensor that a step's row of
    ``chunk_scalars`` holds (the form a CUDA graph of the step reads)."""
    _compare_loss_and_gradients(setup, TCFG, use_rdf, step_tensor=True)


def test_full_field_coarse_pass_matches(setup, shared_noise):
    """``kernel_dir_coarse=False`` in the fast mode: the coarse pass
    evaluates the full field with its spatial gradient, which is what the
    JAX package's kernel path does with ``pallas_dir_coarse=False``, so
    losses and gradients match it in the residual phase too. Both in the
    default mode (``pallas_matmul_precision="default"``: its fast encoding
    and reverse-sweep gradient), the JAX side through its Pallas kernels in
    interpret mode (``torch_mxu.interpret``; on the CPU it otherwise takes
    its XLA path), with f32 products on both sides: the JAX package's own
    on the CPU, the port's twins without their bf16 rounding
    (``torch_mxu.port_unrounded``). With the rounding on both sides
    (``mxu_default``) two f32 implementations round a few operands apart,
    which moves the eikonal term by ~1.5e-5 and the hypernetwork's
    gradients by up to 1e-3 of scale, 20-40x below the rounding's own
    effect; ``test_torch_precision.py`` holds the rounding to the JAX
    package's."""
    cfg = topt.OptimizationConfig(kernel_dir_coarse=False, **CFG)
    assert cfg.kernel_matmul_precision == "default"
    jcfg = jopt.OptimizationConfig(pallas_dir_coarse=False, pallas_tile=32, pallas_bwd_tile=32,
                                   pallas_box_tile=32, **CFG)
    assert jcfg.pallas_matmul_precision == "default"
    with interpret(), port_unrounded():
        _compare_loss_and_gradients(setup, cfg, use_rdf=True, jcfg=jcfg)


def _compare_loss_and_gradients(setup, tcfg, use_rdf, jcfg=JCFG, step_tensor=False):
    jf, tf, params, ray_idx = setup
    step = 5

    def loss_fn(p):
        return jopt.compute_loss(p, jf, jnp.asarray(step), jax.random.PRNGKey(2), jcfg,
                                 use_rdf, ray_indices=jnp.asarray(ray_idx, jnp.int32))

    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tp = convert.params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(tp)]
    tstep = torch.tensor(float(step)) if step_tensor else step
    total2, aux2 = topt.compute_loss(tp, tf, tstep, tcfg, use_rdf,
                                     ray_indices=torch.as_tensor(ray_idx))
    grads2 = torch.autograd.grad(total2, leaves, allow_unused=True)

    np.testing.assert_allclose(float(total2.detach()), float(total), rtol=1e-5)
    for name, value in aux["losses"].items():
        np.testing.assert_allclose(float(aux2["losses"][name].detach()), float(value), rtol=1e-5,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(aux2["row_to_col"].numpy()[:3], np.asarray(aux["row_to_col"])[:3])
    ref = dict(topt.tree_leaves(convert.params_from_jax(jax.device_get(grads), device="cpu")))
    for (path, _), g in zip(topt.tree_leaves(tp), grads2):
        expected = ref[path].numpy()
        got = np.zeros_like(expected) if g is None else g.numpy()
        if not use_rdf and (path[0] == "hyper" or path[-1] == "embeddings"):
            assert g is None and not expected.any(), path      # unused in warmup
            continue
        assert _rel(got, expected) <= 1e-4, path


def test_three_steps_across_the_warmup_boundary_match(setup, shared_noise):
    """Steps 0-1 box-only, step 2 the first with the residual field: the
    embeddings' and hypernetwork's first Adam update uses the
    bias-correction offset of warmup_steps."""
    _three_steps_match(setup, table=False)


def test_three_steps_from_one_chunk_table_match(setup, shared_noise):
    """The same three steps with their numbers (the step index, Adam's
    decayed step sizes and bias corrections per group) from one table of
    ``chunk_scalars``, as ``optimize_chunk`` feeds them."""
    _three_steps_match(setup, table=True)


def _three_steps_match(setup, table: bool):
    jf, tf, params, ray_idx = setup
    tx = jopt.make_optimizer(JCFG, params)
    jstate = tx.init(params)
    jstep = jax.jit(jopt.train_step, static_argnames=("cfg", "tx"))
    jparams = params
    tp = convert.params_from_jax(params, device="cpu")
    tstate = convert.adam_state_from_jax(jax.device_get(jstate), device="cpu")
    optimizer = topt.Adam(TCFG)
    rows = topt.chunk_scalars(TCFG, optimizer, 0, tstate["count"], 3, "cpu") if table else None
    for step in range(3):
        jparams, jstate, jscalars = jstep(jparams, jstate, jf, jnp.asarray(step),
                                          jax.random.PRNGKey(step), JCFG, tx,
                                          ray_indices=jnp.asarray(ray_idx, jnp.int32))
        tscalars = topt.train_step(tp, tstate, tf, step, TCFG, optimizer,
                                   ray_indices=torch.as_tensor(ray_idx),
                                   scalars=None if rows is None else rows[step])
        for name in ("loss", "silhouette_loss", "eikonal_loss", "iou_3d", "num_matched"):
            np.testing.assert_allclose(float(tscalars[name]), float(jscalars[name]),
                                       rtol=1e-5, atol=1e-8, err_msg=f"{name} @ {step}")

    jparams, jstate = jax.device_get(jparams), jax.device_get(jstate)
    assert tstate["count"] == int(jstate["count"]) == 3
    before = dict(topt.tree_leaves(convert.params_from_jax(params, device="cpu")))
    after = dict(topt.tree_leaves(convert.params_from_jax(jparams, device="cpu")))
    mu = dict(topt.tree_leaves(convert.params_from_jax(jstate["mu"], device="cpu")))
    nu = dict(topt.tree_leaves(convert.params_from_jax(jstate["nu"], device="cpu")))
    tmu = dict(topt.tree_leaves(tstate["mu"]))
    tnu = dict(topt.tree_leaves(tstate["nu"]))
    for path, value in topt.tree_leaves(tp):
        # the moments are smooth in the gradients: compare them everywhere
        assert _rel(tmu[path].numpy(), mu[path].numpy()) <= 1e-4, ("mu", path)
        assert _rel(tnu[path].numpy(), nu[path].numpy()) <= 1e-4, ("nu", path)
        # an update's size is m_hat / sqrt(v_hat): +-lr on a first step, so
        # compare it where the gradient is well above rounding noise
        moved = value.numpy() - before[path].numpy()
        expected = after[path].numpy() - before[path].numpy()
        m = np.abs(mu[path].numpy())
        solid = m > 1e-3 * m.max() if m.max() > 0 else np.zeros_like(m, bool)
        ulps = 2 * np.spacing(np.float32(np.abs(before[path].numpy()).max()))
        np.testing.assert_allclose(moved[solid], expected[solid], rtol=1e-3, atol=ulps,
                                   err_msg=str(path))
    # the offset makes the hypernetwork's first update a full +-lr step
    v0 = ("hyper", "layers", 0, "v")
    step_size = np.abs(tp["hyper"]["layers"][0]["v"].numpy() - before[v0].numpy())
    solid = np.abs(mu[v0].numpy()) > 1e-3 * np.abs(mu[v0].numpy()).max()
    ulps = 2 * np.spacing(np.float32(np.abs(before[v0].numpy()).max()))
    np.testing.assert_allclose(step_size[solid], JCFG.hypernetwork_lr * JCFG.lr_decay ** 2,
                               rtol=1e-3, atol=ulps)


def test_default_config_runs_the_box_only_directional_coarse_pass(monkeypatch):
    """The fast configuration (port only): the coarse pass goes through
    K3's path without the residual field in both phases, and the losses
    stay finite."""
    calls = []
    dir_forward = field_kernels.fused_field_dir_forward

    def spy(*args):
        calls.append(args[6] is None)            # weights: None = box only
        return dir_forward(*args)

    monkeypatch.setattr(field_kernels, "fused_field_dir_forward", spy)
    frame = tfm.synthetic_frame(3, num_views=2, image_size=(32, 48), num_instances=2,
                                max_instances=3, device="cpu")
    cfg = topt.OptimizationConfig(num_steps=4, warmup_steps=2, num_rays=16, num_samples=6,
                                  checkpoint_interval=2, metric_interval=2)
    params, scalars = topt.optimize_frame(frame, 0, cfg)
    assert calls == [True] * 4
    assert scalars["loss"].shape == (4,)
    for name, values in scalars.items():
        assert np.all(np.isfinite(values)), name
    assert scalars["eikonal_loss"][0] == 0 and scalars["eikonal_loss"][3] > 0
    assert scalars["num_matched"][1] == 2


def test_residual_coarse_pass_goes_through_k3_with_the_field(setup, monkeypatch):
    """``kernel_box_coarse=False`` in the fast mode: after warmup the
    directional coarse pass gets the residual field's weights (detached),
    during warmup the box union only; losses and gradients stay finite."""
    _, tf, params, ray_idx = setup
    calls = []
    dir_forward = field_kernels.fused_field_dir_forward

    def spy(*args):
        weights = args[6]
        calls.append(None if weights is None else weights.requires_grad)
        return dir_forward(*args)

    monkeypatch.setattr(field_kernels, "fused_field_dir_forward", spy)
    cfg = topt.OptimizationConfig(kernel_box_coarse=False, **CFG)
    for use_rdf in (False, True):
        tp = convert.params_from_jax(params, device="cpu")
        leaves = [t.requires_grad_() for _, t in topt.tree_leaves(tp)]
        total, aux = topt.compute_loss(tp, tf, 5, cfg, use_rdf,
                                       generator=torch.Generator().manual_seed(0),
                                       ray_indices=torch.as_tensor(ray_idx))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        assert torch.isfinite(total)
        for name, value in aux["losses"].items():
            assert torch.isfinite(value), name
        for (path, _), g in zip(topt.tree_leaves(tp), grads):
            assert g is None or torch.all(torch.isfinite(g)), path
    assert calls == [None, False]
    assert float(aux["losses"]["eikonal_loss"].detach()) > 0
