"""The port's photometric branch, SSIM and full-image renders against the
JAX package's, at the sizes of tests/test_photometric_pipeline.py: 3 views
at 48x64, 2 instances, 16 surface rays, 24 iterations.

Both packages run in strict mode (f32 field, matmul precision 'highest').
The JAX package draws its surface pixels from a key inside the loss; the
tests draw them with the JAX sampler from the same key and hand them to
the port as ``local_idx`` (``surface_indices`` in ``compute_loss``).

Tolerances: the loss 1e-5 (sums of correlations of bilinear patch
samples); its pullback to the box parameters and the hypernetwork 1e-3
relative to each parameter's gradient scale (the gradient passes through
the field's second derivatives, homographies and top-k correlations);
SSIM 1e-6; the instance-probability render 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.losses import photometric as jloss
from vsrd_tpu.models import box_parameters as jbox, hyper_field as jhyper
from vsrd_tpu.ops import sampling as jsampling
from vsrd_tpu.pipeline import frame as jfm, optimize as jopt, photometric as jpm
from vsrd_tpu.pipeline import render_image as jri
from vsrd_tpu.rendering import scene as jscene
from vsrd_tpu_torch.losses import photometric as tloss
from vsrd_tpu_torch.models import box_parameters as tbox, hyper_field as thyper
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt, photometric as tpm
from vsrd_tpu_torch.pipeline import render_image as tri, sharded
from vsrd_tpu_torch.rendering import scene as tscene
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)

CFG = dict(num_steps=6, warmup_steps=2, num_rays=48, num_samples=8, photometric_weight=0.1,
           surface_num_rays=16, surface_num_iterations=24, checkpoint_interval=6)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
SURFACE = dict(num_rays=16, num_iterations=24)


def _frames(key_index, **kw):
    key = jax.random.PRNGKey(key_index)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    kw = {**dict(num_views=3, image_size=(48, 64), num_instances=2, max_instances=2,
                 with_images=True), **kw}
    return jfm.synthetic_frame(key, **kw), tfm.synthetic_frame(seed, **kw, device="cpu")


@pytest.fixture(scope="module")
def setup():
    jf, tf = _frames(0)
    params = jax.device_get(jopt.init_params(jax.random.PRNGKey(1), 2, JCFG))
    return jf, tf, params


def _jax_local_idx(frame, key, num_rays=16):
    """The JAX loss's draw of target-view pixels from ``key``."""
    h, w = frame.image_size
    soft = jax.lax.dynamic_slice_in_dim(frame.sampling_weights, frame.target_index * h * w,
                                        h * w)
    return np.asarray(jsampling.multinomial_no_replacement(
        key, (soft > 0.5).astype(jnp.float32), num_rays))


def _jax_photo(p, frame, key):
    decoded = jbox.decode_boxes(p["boxes"])
    weights = jhyper.hypernetwork_apply(p["hyper"], decoded["embeddings"])
    sp = jscene.SceneParams(locations=decoded["locations"], rotations=decoded["orientations"],
                            half_dimensions=decoded["dimensions"], valid=frame.valid,
                            field_weights=weights)
    return jpm.photometric_loss(frame, jscene.hard_scene_field(sp), key, **SURFACE)


def _torch_photo(p, frame, local_idx):
    decoded = tbox.decode_boxes(p["boxes"])
    weights = thyper.hypernetwork_apply(p["hyper"], decoded["embeddings"])
    sp = tscene.SceneParams(decoded["locations"], decoded["orientations"],
                            decoded["dimensions"], frame.valid, weights)
    return tpm.photometric_loss(frame, sp, local_idx=local_idx, **SURFACE)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else float(np.abs(a).max())


def test_photometric_loss_and_its_pullback_match_jax(setup):
    jf, tf, params = setup
    key = jax.random.PRNGKey(4)      # frame 0's surfels converge with this key

    def jloss_fn(p):
        loss, conv = _jax_photo(p, jf, key)
        return loss, conv

    (jvalue, jconv), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(params)
    tp = convert.params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(tp)]
    tvalue, tconv = _torch_photo(tp, tf, torch.as_tensor(_jax_local_idx(jf, key)))
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert tconv.any() and float(jvalue) != 0.0
    np.testing.assert_allclose(float(tvalue.detach()), float(jvalue), rtol=1e-5, atol=1e-7)

    tgrads = torch.autograd.grad(tvalue, leaves, allow_unused=True)
    ref = dict(topt.tree_leaves(convert.params_from_jax(jax.device_get(jgrads), device="cpu")))
    moved = 0
    for (path, _), g in zip(topt.tree_leaves(tp), tgrads):
        expected = ref[path].numpy()
        got = np.zeros_like(expected) if g is None else g.numpy()
        assert _rel(got, expected) <= 1e-3, path
        moved += bool(np.abs(expected).max() > 0)
    assert moved >= 4            # boxes and the hypernetwork both get a gradient


def test_compute_loss_photometric_branch_matches_jax(setup):
    """compute_loss at weight 0.1 with both ray overrides: the render's rays
    and the surface pixels that the JAX package draws from its key (split
    off the render's key after the render)."""
    jf, tf, params = setup
    key = jax.random.PRNGKey(2)
    ray_idx = np.asarray(jf.candidate_indices)[np.random.default_rng(0).choice(500, 48, False)]
    _, aux = jax.jit(jopt.compute_loss, static_argnames=("cfg", "use_rdf"))(
        params, jf, jnp.asarray(3), key, JCFG, True, ray_indices=jnp.asarray(ray_idx, jnp.int32))
    _, key_render = jax.random.split(key)
    _, key_surface = jax.random.split(key_render)
    tp = convert.params_from_jax(params, device="cpu")
    _, taux = topt.compute_loss(tp, tf, 3, TCFG, True, ray_indices=torch.as_tensor(ray_idx),
                                surface_indices=torch.as_tensor(_jax_local_idx(jf, key_surface)))
    expected = float(aux["losses"]["photometric_loss"])
    assert expected != 0.0
    np.testing.assert_allclose(float(taux["losses"]["photometric_loss"]), expected,
                               rtol=1e-5, atol=1e-7)
    # the warmup phase and a zero weight leave the branch out
    _, taux = topt.compute_loss(tp, tf, 1, TCFG, False, ray_indices=torch.as_tensor(ray_idx))
    assert float(taux["losses"]["photometric_loss"]) == 0.0


def test_batched_photometric_branch_equals_per_frame(setup):
    jf, tf, params = setup
    _, tf2 = _frames(7)
    p2 = jax.device_get(jopt.init_params(jax.random.PRNGKey(5), 2, JCFG))
    tps = [convert.params_from_jax(p, device="cpu") for p in (params, p2)]
    # frame 0's surfels converge from these pixels
    idx = torch.stack([torch.as_tensor(_jax_local_idx(jf, jax.random.PRNGKey(4))),
                       tpm.surface_indices(tf2, 16, torch.Generator().manual_seed(6))])
    stacked = sharded.stack_frames([tf, tf2])
    batched = topt.tree_stack(tps)
    ray_idx = torch.stack([f.candidate_indices[:48] for f in (tf, tf2)])
    _, baux = topt.compute_loss(batched, stacked, 3, TCFG, True, ray_indices=ray_idx,
                                surface_indices=idx)
    singles = [topt.compute_loss(tps[f], (tf, tf2)[f], 3, TCFG, True, ray_indices=ray_idx[f],
                                 surface_indices=idx[f])[1]["losses"]["photometric_loss"]
               for f in range(2)]
    got = baux["losses"]["photometric_loss"].detach().numpy()
    np.testing.assert_allclose(got, [float(s) for s in singles], rtol=1e-5, atol=1e-7)
    assert np.abs(got).max() > 0


def test_optimize_frame_runs_the_photometric_branch():
    _, tf = _frames(0)
    params, scalars = topt.optimize_frame(tf, 3, TCFG)
    assert np.isfinite(scalars["loss"]).all()
    photo = scalars["photometric_loss"]
    assert (photo[: TCFG.warmup_steps] == 0.0).all()
    assert np.isfinite(photo).all() and np.abs(photo[TCFG.warmup_steps:]).max() > 0.0


def test_stack_frames_keeps_images_or_refuses_a_mix():
    _, with_images = _frames(0)
    without = tfm.synthetic_frame(5, num_views=3, image_size=(48, 64), num_instances=2,
                                  max_instances=2, device="cpu")
    stacked = sharded.stack_frames([with_images, with_images])
    assert stacked.gray_images.shape == (2, 3, 48, 64)
    assert sharded.stack_frames([without, without]).gray_images is None
    with pytest.raises(ValueError, match="gray_images"):
        sharded.stack_frames([with_images, without])


def test_ssim_and_photometric_blend_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 12, 16)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape).astype(np.float32) * 0.2, 0, 1)
    for name in ("ssim_loss", "photometric_loss"):
        for reduction in ("none", "mean", "sum"):
            j = getattr(jloss, name)(jnp.asarray(x), jnp.asarray(y), reduction=reduction)
            t = getattr(tloss, name)(torch.from_numpy(x), torch.from_numpy(y),
                                     reduction=reduction)
            scale = 1.0 if reduction != "sum" else float(np.abs(np.asarray(j)))
            np.testing.assert_allclose(t.numpy() / scale, np.asarray(j) / scale, atol=1e-6,
                                       rtol=0, err_msg=f"{name} {reduction}")
    with pytest.raises(ValueError):
        tloss.ssim_loss(torch.from_numpy(x), torch.from_numpy(y), reduction="max")


@pytest.fixture(scope="module")
def small():
    jf, tf = _frames(3, num_views=2, image_size=(24, 32))
    params = jax.device_get(jopt.init_params(jax.random.PRNGKey(1), 2, JCFG))
    rng = np.random.default_rng(0)
    params["boxes"]["locations"] = jnp.asarray(
        rng.normal(size=(2, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, -1.5]))
    return jf, tf, params


@pytest.mark.parametrize("step", [1, 4])
def test_render_images_match_jax(small, step):
    """Both renders of view 0, box-only (step 1) and with the residual field
    (step 4)."""
    jf, tf, params = small
    cfg = dict(CFG, surface_num_iterations=60)
    jcfg = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **cfg)
    tcfg = topt.OptimizationConfig(kernel_matmul_precision="highest", **cfg)
    tp = convert.params_from_jax(params, device="cpu")
    jprob = np.asarray(jri.render_instance_probabilities(params, jf, step, jcfg))
    tprob = tri.render_instance_probabilities(tp, tf, step, tcfg)
    assert tprob.shape == (24, 32, 2)
    np.testing.assert_allclose(tprob.numpy(), jprob, atol=1e-5, rtol=0)
    jmask = np.asarray(jri.render_surface_mask(params, jf, step, jcfg))
    tmask = tri.render_surface_mask(tp, tf, step, tcfg)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert tmask.any()
