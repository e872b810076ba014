"""Co-optimized frame batches in the PyTorch port: the batched twins of
K4a/K4b/K4c, ``compute_loss``/``train_step`` on stacked frames and
``optimize_frames_batched``, against the JAX package's batched path and
against the port's own single-frame path.

Shapes: F=2 frames of 2 views at 32x48, N=4 instances (3 real), strict
mode on both sides (field in f32, matmul precision 'highest'); the two
frames have different target views. The samplers' [F, rays, samples]
uniforms come from noise this module hands to both packages, as in
``test_torch_optimize.py``. The second frame is the scene of seed 2: with
seed 1's scene and these parameters a fine sample lies within rounding of
a box facet, where the box SDF's gradient jumps, and the two packages
then disagree on that sample's second-order term by 5e-4 of one
orientation gradient in single-frame runs as well.

Tolerances, with their reasons (as in ``test_torch_field_kernels.py`` and
``test_torch_optimize.py``):
* twins against the Pallas kernels in interpret mode: u and w 2e-6
  absolute; grad_x u and u_dot 1e-5 relative to the reference's scale
  (max(max|ref|, 1)), since in a frame with no valid instance the uniform
  union adds up every instance's gradient and |grad_x u| reaches ~4.5
  (one frame's rounding, 1e-5 absolute at |grad| <= 1, scaled with it);
  the pullback 1e-4 relative to the reference's scale;
* losses 1e-5 relative, gradients 1e-4 relative to each parameter's
  gradient scale (f32 sums in another order). The eikonal term
  mean((|g| - 1)^2) inherits the field gradient's 1e-5 absolute
  disagreement (the JAX field's GELU uses a rational erf): by
  Cauchy-Schwarz it moves by at most 2e-5 * sqrt(eikonal), which is its
  bound here (the per-frame total still agrees to 1e-5 relative);
* the port's batched path against its single-frame path: losses 1e-5,
  gradients 2e-4 (batched matmuls round differently at the 1e-7 level,
  as ``tests/test_batched.py`` allows in the JAX package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.ops import sampling as jsampling
from vsrd_tpu.pipeline import frame as jfm, optimize as jopt, sharded as jsh
from vsrd_tpu.rendering import fused_field as ff
from vsrd_tpu.rendering import pallas_field as pf
from vsrd_tpu_torch.models import hyper_field as thf
from vsrd_tpu_torch.ops import matching as tmatch, sampling as tsampling
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt, sharded as tsh
from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import fused_field as tff
from vsrd_tpu_torch.rendering import samplers as tsamplers
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)

F, N, RAYS, SAMPLES = 2, 4, 16, 6
TAU = 0.5
KW = dict(num_views=2, image_size=(32, 48), num_instances=3, max_instances=N)
CFG = dict(num_steps=20, warmup_steps=2, num_rays=RAYS, num_samples=SAMPLES,
           deterministic=False, checkpoint_interval=3, metric_interval=2)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
NOISE = np.random.default_rng(7).random((2, F, RAYS, SAMPLES)).astype(np.float32)
SCENES, TARGETS = (0, 2), (0, 1)
CAND = np.random.default_rng(11).permutation(1000)[: F * RAYS].reshape(F, RAYS)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else float(np.abs(a).max())


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


# ---------------------------------------------------------------- K4a-c twins

def _field_inputs(seed=0, p=96):
    """[F, ...] field inputs; frame 1 has no valid instance."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1, 1, (F, N))
    dirs = rng.normal(size=(F, p, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rot = [[[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]] for a in row]
           for row in angles]
    x = dict(
        pos=rng.normal(size=(F, p, 3)) * 5, loc=rng.normal(size=(F, N, 3)) * 3,
        rot=np.asarray(rot), half=rng.uniform(0.5, 2.0, size=(F, N, 3)),
        valid=np.asarray([[1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0]]),
        w=rng.normal(size=(F, N, fk.NUM_WEIGHTS)) * 0.3, dirs=dirs,
        du=rng.normal(size=(F, p)), dw=rng.normal(size=(F, p, N)), dg=rng.normal(size=(F, p, 3)),
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}


def _statics(use_rdf):
    return ff.FieldStatics(num_instances=N, use_rdf=use_rdf, field_dtype=None,
                           matmul_precision="highest")


def _layers(w, use_rdf):
    return jax.vmap(ff.build_interleaved_layers)(jnp.asarray(w)) if use_rdf else ()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pf, "INTERPRET", True)


@pytest.mark.parametrize("use_rdf", [False, True])
def test_k4a_twin_matches_pallas_batched_forward(interpret, use_rdf):
    x = _field_inputs()
    u, w, g = pf.fused_field_with_grad(
        _statics(use_rdf), 32, jnp.asarray(x["pos"]), x["loc"], x["rot"], x["half"],
        x["valid"], _layers(x["w"], use_rdf), TAU)
    args = [_t(x[k]) for k in ("pos", "loc", "rot", "half", "valid")]
    u2, w2, g2 = tff.scene_eval_with_grad_batched(
        *args, _t(x["w"]) if use_rdf else None, torch.tensor(TAU))
    u2, w2, g2 = u2.detach(), w2.detach(), g2.detach()
    assert u2.shape == (F, 96) and w2.shape == (F, 96, N) and g2.shape == (F, 96, 3)
    np.testing.assert_allclose(u2.numpy(), np.asarray(u), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w), atol=2e-6, rtol=2e-7)
    for f in range(F):
        assert _err(g2[f].numpy(), np.asarray(g)[f]) <= 1e-5, f
    # frame 1 has no valid instance: uniform weights; frame 0 none on the pad
    np.testing.assert_allclose(w2[1].numpy(), 1.0 / N, rtol=1e-6)
    assert not w2[0, :, 3].any()


@pytest.mark.parametrize("use_rdf", [False, True])
def test_k4c_twin_pullback_matches_pallas_batched_backward(interpret, use_rdf):
    x = _field_inputs(seed=1)
    statics = _statics(use_rdf)

    def jax_field(loc, rot, half, w):
        return pf.fused_field_with_grad(statics, 32, jnp.asarray(x["pos"]), loc, rot, half,
                                        x["valid"], _layers(w, use_rdf), TAU)

    _, vjp = jax.vjp(jax_field, *(jnp.asarray(x[k]) for k in ("loc", "rot", "half", "w")))
    ref = vjp((jnp.asarray(x["du"]), jnp.asarray(x["dw"]), jnp.asarray(x["dg"])))

    params = [_t(x[k]).requires_grad_() for k in ("loc", "rot", "half", "w")]
    u, w, g = fk.fused_field_with_grad(_t(x["pos"]), *params[:3], _t(x["valid"]),
                                       params[3] if use_rdf else None, torch.tensor(TAU))
    loss = (u * _t(x["du"])).sum() + (w * _t(x["dw"])).sum() + (g * _t(x["dg"])).sum()
    got = torch.autograd.grad(loss, params if use_rdf else params[:3])
    for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), got, ref):
        assert a.shape == b.shape, name
        assert _err(a.numpy(), b) <= 1e-4, name


@pytest.mark.parametrize("use_rdf", [False, True])
def test_k4b_twin_matches_pallas_batched_dir_forward(interpret, use_rdf):
    x = _field_inputs(seed=2)
    u, w, ud = pf.fused_field_dir_forward(
        _statics(use_rdf), 32, jnp.asarray(x["pos"]), jnp.asarray(x["dirs"]), x["loc"],
        x["rot"], x["half"], x["valid"], _layers(x["w"], use_rdf), TAU)
    args = [_t(x[k]) for k in ("pos", "dirs", "loc", "rot", "half", "valid")]
    u2, w2, ud2 = fk.fused_field_dir_forward(*args, _t(x["w"]) if use_rdf else None,
                                             torch.tensor(TAU))
    np.testing.assert_allclose(u2.numpy(), np.asarray(u), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w), atol=2e-6, rtol=2e-7)
    for f in range(F):
        assert _err(ud2[f].numpy(), np.asarray(ud)[f]) <= 1e-5, f


def test_batched_twins_are_the_single_frame_twins_per_frame():
    x = _field_inputs(seed=3)
    keys = ("pos", "loc", "rot", "half", "valid", "w")
    batched = fk.fused_field_with_grad(*(_t(x[k]) for k in keys), torch.tensor(TAU))
    dirs = fk.fused_field_dir_forward(_t(x["pos"]), _t(x["dirs"]),
                                      *(_t(x[k]) for k in keys[1:]), torch.tensor(TAU))
    for f in range(F):
        single = tff.scene_eval_with_grad(*(_t(x[k][f]) for k in keys), torch.tensor(TAU))
        for a, b in zip(batched, single):
            torch.testing.assert_close(a[f], b, rtol=0, atol=0)
        single = tff.scene_eval_dir(_t(x["pos"][f]), _t(x["dirs"][f]),
                                    *(_t(x[k][f]) for k in keys[1:]), torch.tensor(TAU))
        for a, b in zip(dirs, single):
            torch.testing.assert_close(a[f], b, rtol=0, atol=0)
    before = (fk.field_forward.launches, fk.field_forward.batched_launches)
    with pytest.raises(ValueError):      # the launchers take CUDA tensors only
        fk.field_forward(*(_t(x[k]) for k in keys), torch.tensor(TAU))
    assert (fk.field_forward.launches, fk.field_forward.batched_launches) == before


# ---------------------------------------------------------------- the loss

@pytest.fixture(scope="module")
def setup():
    """Two frames (different scenes and target views) in both packages,
    stacked; batched JAX params with boxes that see the scenes."""
    jframes, tframes = [], []
    for i, target in enumerate(TARGETS):
        key = jax.random.PRNGKey(SCENES[i])
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        jf = jfm.synthetic_frame(key, **KW)
        tf = tfm.synthetic_frame(seed, **KW, device="cpu")
        jframes.append(jf._replace(target_index=jnp.asarray(target, jnp.int32)))
        tframes.append(dataclasses.replace(tf, target_index=target))
    params = jopt.init_params_batched(jax.random.PRNGKey(1), F, N, JCFG)
    rng = np.random.default_rng(0)
    params["boxes"]["locations"] = jnp.asarray(
        rng.normal(size=(F, N, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, -1.5]))
    params["boxes"]["embeddings"] = jnp.asarray(rng.normal(size=(F, N, 256)).astype(np.float32))
    ray_idx = np.stack([np.asarray(jf.candidate_indices)[CAND[f]]
                        for f, jf in enumerate(jframes)])
    return (jframes, tframes, jsh.stack_frames(jframes), tsh.stack_frames(tframes),
            jax.device_get(params), ray_idx)


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages' sampler uniforms come from NOISE, alternating coarse
    (quadrature) and fine (importance) draws in call order: [F, R, S]
    draws for stacked frames, frame ``state["frame"]``'s [R, S] slice for a
    single frame."""
    state = {"jax": 0, "torch": 0, "frame": 0}
    jax_uniform = jax.random.uniform

    def noise(calls, shape):
        full = NOISE[(calls - 1) % 2]
        return full if tuple(shape) == full.shape else full[state["frame"]]

    def fake_jax(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        if tuple(shape) not in ((F, RAYS, SAMPLES), (RAYS, SAMPLES)):
            return jax_uniform(key, shape, dtype, *args, **kwargs)
        state["jax"] += 1
        return jnp.asarray(noise(state["jax"], shape), dtype)

    def fake_torch(shape, generator, like):
        assert tuple(shape) in ((F, RAYS, SAMPLES), (RAYS, SAMPLES)), shape
        state["torch"] += 1
        return torch.from_numpy(noise(state["torch"], shape)).to(like.dtype)

    monkeypatch.setattr(jax.random, "uniform", fake_jax)
    monkeypatch.setattr(tsamplers, "_uniform", fake_torch)
    return state


def _port_loss_and_grads(params, frame, cfg, use_rdf, ray_idx, step=5):
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
    total, aux = topt.compute_loss(params, frame, step, cfg, use_rdf,
                                   ray_indices=torch.as_tensor(ray_idx))
    grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
    return total.detach(), aux, grads


@pytest.mark.parametrize("use_rdf", [False, True])
def test_batched_compute_loss_and_gradients_match_jax(setup, shared_noise, use_rdf):
    _, _, jfb, tfb, params, ray_idx = setup
    step = 5

    def loss_fn(p):
        total, aux = jopt.compute_loss(p, jfb, jnp.asarray(step), jax.random.PRNGKey(2), JCFG,
                                       use_rdf, ray_indices=jnp.asarray(ray_idx, jnp.int32))
        return jnp.sum(total), (total, aux)

    (_, (total, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tp = convert.params_from_jax(params, device="cpu")
    total2, aux2, grads2 = _port_loss_and_grads(tp, tfb, TCFG, use_rdf, ray_idx, step)

    assert total2.shape == (F,)
    np.testing.assert_allclose(total2.numpy(), np.asarray(total), rtol=1e-5)
    for name, value in aux["losses"].items():
        got, value = aux2["losses"][name].detach().numpy(), np.asarray(value)
        assert got.shape == (F,), name
        if name == "eikonal_loss":
            assert np.all(np.abs(got - value) <= 2e-5 * np.sqrt(value)), (got, value)
        else:
            np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-8, err_msg=name)
    valid = np.asarray(jfb.valid)
    np.testing.assert_array_equal(aux2["row_to_col"].numpy()[valid],
                                  np.asarray(aux["row_to_col"])[valid])
    ref = dict(topt.tree_leaves(convert.params_from_jax(jax.device_get(grads), device="cpu")))
    for (path, _), g in zip(topt.tree_leaves(tp), grads2):
        expected = ref[path].numpy()
        if not use_rdf and (path[0] == "hyper" or path[-1] == "embeddings"):
            assert g is None and not expected.any(), path      # unused in warmup
            continue
        for f in range(F):
            assert _rel(g[f].numpy(), expected[f]) <= 1e-4, (path, f)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("use_rdf", [False, True])
def test_batched_path_matches_single_frame_path(setup, shared_noise, use_rdf, strict):
    """Each frame's loss, matching and gradients from the stacked frames
    equal those of the frame run alone (in the fast mode too, where the
    coarse pass goes through the K4b/K3 twins)."""
    _, tframes, _, tfb, params, ray_idx = setup
    cfg = TCFG if strict else topt.OptimizationConfig(**CFG)
    total_b, aux_b, grads_b = _port_loss_and_grads(
        convert.params_from_jax(params, device="cpu"), tfb, cfg, use_rdf, ray_idx)
    for f in range(F):
        shared_noise["frame"] = f
        params_f = convert.params_from_jax(jax.tree.map(lambda a: a[f], params), device="cpu")
        total_s, aux_s, grads_s = _port_loss_and_grads(params_f, tframes[f], cfg, use_rdf,
                                                       ray_idx[f])
        np.testing.assert_allclose(float(total_b[f]), float(total_s), rtol=1e-5, atol=1e-8)
        for name, value in aux_s["losses"].items():
            np.testing.assert_allclose(float(aux_b["losses"][name][f].detach()),
                                       float(value.detach()),
                                       rtol=1e-5, atol=1e-8, err_msg=name)
        torch.testing.assert_close(aux_b["row_to_col"][f], aux_s["row_to_col"])
        torch.testing.assert_close(aux_b["cam_corners_target"][f], aux_s["cam_corners_target"],
                                   rtol=1e-6, atol=1e-6)
        for (path, _), a, b in zip(topt.tree_leaves(params_f), grads_b, grads_s):
            assert (a is None) == (b is None), path
            if b is not None:
                assert _rel(a[f].numpy(), b.numpy()) <= 2e-4, (path, f)


def test_three_batched_steps_across_the_warmup_boundary_match_jax(setup, shared_noise,
                                                                   monkeypatch):
    """JAX's jitted ``optimize_chunk`` and the port's on the stacked frames,
    steps 0-2 (the last the first with the residual field), with the ray
    draw fixed to the same candidates on both sides."""
    _, _, jfb, tfb, params, _ = setup
    monkeypatch.setattr(jsampling, "multinomial_logits",
                        lambda key, logits, k, **kw: jnp.asarray(CAND, jnp.int32))
    monkeypatch.setattr(tsampling, "multinomial_logits",
                        lambda logits, k, generator=None: torch.as_tensor(CAND))
    tx = jopt.make_optimizer(JCFG, params)
    jstate = tx.init(params)
    jparams, jstate, jscalars = jopt.optimize_chunk(params, jstate, jfb, jax.random.PRNGKey(0),
                                                    jnp.asarray(0), JCFG, 3)
    tp = convert.params_from_jax(params, device="cpu")
    tstate = convert.adam_state_from_jax(jax.device_get(tx.init(params)), device="cpu")
    tscalars = topt.optimize_chunk(tp, tstate, tfb, 0, 0, TCFG, 3)
    for name in ("loss", "silhouette_loss", "eikonal_loss", "iou_3d", "num_matched"):
        assert tscalars[name].shape == (3, F), name
        np.testing.assert_allclose(tscalars[name], np.asarray(jscalars[name]), rtol=1e-5,
                                   atol=1e-8, err_msg=name)
    assert tscalars["num_matched"][1].tolist() == [3.0, 3.0]

    jstate = jax.device_get(jstate)
    assert tstate["count"] == int(jstate["count"]) == 3
    for key in ("mu", "nu"):
        ref = dict(topt.tree_leaves(convert.params_from_jax(jstate[key], device="cpu")))
        for path, value in topt.tree_leaves(tstate[key]):
            assert _rel(value.numpy(), ref[path].numpy()) <= 1e-4, (key, path)


def test_optimize_frames_batched_scalars_and_metric_cadence(setup):
    tfb = setup[3]
    cfg = topt.OptimizationConfig(num_steps=4, warmup_steps=2, num_rays=RAYS,
                                  num_samples=SAMPLES, checkpoint_interval=2, metric_interval=2)
    seen = []
    params, scalars = topt.optimize_frames_batched(
        tfb, 7, cfg, callback=lambda step, p, chunk, state: seen.append(
            (step, chunk["loss"].shape, state["count"])))
    assert seen == [(2, (2, F), 2), (4, (2, F), 4)]
    for name, values in scalars.items():
        assert values.shape == (4, F), name
        assert np.all(np.isfinite(values)), name
    matched = scalars["num_matched"]
    assert (matched[1::2] == 3.0).all() and (matched[0::2] == 0.0).all()
    assert (scalars["eikonal_loss"][:2] == 0).all() and (scalars["eikonal_loss"][2:] > 0).all()
    for path, leaf in topt.tree_leaves(params):
        assert leaf.shape[0] == F and torch.all(torch.isfinite(leaf)), path
    # frame 0 starts from optimize_frame's init with the same seed
    first = topt.init_params(torch.Generator().manual_seed(7), N, cfg)
    stacked = topt.init_params_batched(7, F, N, cfg, device="cpu")
    for (path, a), (_, b) in zip(topt.tree_leaves(first), topt.tree_leaves(stacked)):
        torch.testing.assert_close(b[0], a, rtol=0, atol=0)


# ---------------------------------------------------------------- modules

def test_stack_frames_keeps_each_frames_target_view(setup):
    jframes, tframes, jfb, tfb, _, ray_idx = setup
    assert tfb.num_frames == F and tframes[0].num_frames is None
    assert tfb.target_index.tolist() == [0, 1] == np.asarray(jfb.target_index).tolist()
    assert tfb.image_size == tframes[0].image_size
    for field in dataclasses.fields(tfb):
        value = getattr(tfb, field.name)
        if isinstance(value, torch.Tensor) and field.name != "target_index":
            for f in range(F):
                torch.testing.assert_close(value[f], getattr(tframes[f], field.name), rtol=0,
                                           atol=0, equal_nan=True, msg=field.name)
    origins, directions = tfm.ray_directions_at(tfb, torch.as_tensor(ray_idx))
    assert origins.shape == directions.shape == (F, RAYS, 3)
    for f in range(F):
        o, d = tfm.ray_directions_at(tframes[f], torch.as_tensor(ray_idx[f]))
        torch.testing.assert_close(origins[f], o, rtol=0, atol=0)
        torch.testing.assert_close(directions[f], d, rtol=0, atol=0)


@pytest.mark.parametrize("n", [4, 8])
def test_batched_matching_matches_per_frame(n):
    rng = np.random.default_rng(n)
    cost = torch.from_numpy(rng.normal(size=(3, n, n)).astype(np.float32))
    valid = torch.from_numpy(np.arange(n)[None, :] < np.array([[n], [n - 1], [2]]))
    batched = tmatch.masked_linear_sum_assignment(cost, valid, valid)
    assert batched.shape == (3, n)
    for f in range(3):
        single = tmatch.masked_linear_sum_assignment(cost[f], valid[f], valid[f])
        assert torch.equal(batched[f], single)
    with pytest.raises(NotImplementedError):
        tmatch.masked_linear_sum_assignment(torch.zeros(2, 9, 9), torch.ones(2, 9, dtype=bool),
                                            torch.ones(2, 9, dtype=bool))


def test_hypernetwork_apply_on_stacked_params():
    hyper = [thf.init_hyper_field(torch.Generator().manual_seed(s)) for s in range(F)]
    stacked = topt.tree_stack(hyper)
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(F, N, 256)).astype(np.float32))
    got = thf.hypernetwork_apply(stacked, emb)
    assert got.shape == (F, N, 1617)
    for f in range(F):
        ref = thf.hypernetwork_apply(hyper[f], emb[f])
        np.testing.assert_allclose(got[f].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


def test_convert_carries_stacked_params_and_adam_state():
    params = jax.device_get(jopt.init_params_batched(jax.random.PRNGKey(4), F, N, JCFG))
    state = jax.device_get(jopt.make_optimizer(JCFG, params).init(params))
    tp = dict(topt.tree_leaves(convert.params_from_jax(params, device="cpu")))
    ts = convert.adam_state_from_jax(state, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(tp)
    for jpath, leaf in leaves:
        path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath)
        assert tp[path].shape[0] == F and tp[path].dtype == torch.float32, path
        np.testing.assert_array_equal(tp[path].numpy(), np.asarray(leaf))
    assert ts["count"] == 0
    for key in ("mu", "nu"):
        for path, value in topt.tree_leaves(ts[key]):
            assert value.shape[0] == F and not value.any(), (key, path)
