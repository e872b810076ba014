"""Per-tile instance-group skipping in the PyTorch port, and the rendering
layer's last two modules, against the JAX package.

* the keep mask: ``fused_field.group_tile_mask`` equals the JAX package's
  entry for entry (N = 16, and N = 12 against JAX's scene padded to 16 with
  invalid slots; P not a multiple of the tile, an invalid slot, a frame with
  no valid instance; the 60 m-offset scene of ``test_group_skip._scene``,
  whose far group drops; stacked frames);
* the masked twins against the Pallas kernels in skip mode
  (``statics.group_skip``, interpret mode, tile 32, 96 points, tau = 0.25,
  f32 field): u, w and grad_x u to 1e-5, the pullback to the per-instance
  weights at ``test_group_skip.py``'s own 1e-3, the directional forward,
  and the batched form with per-frame masks;
* ``compute_loss`` with ``kernel_group_skip``: the instance and ray orders
  equal the JAX package's index for index, and loss and gradients match the
  JAX package with the skip off (its strict field path) at the tolerance of
  the JAX package's own on/off test (loss 1e-4 relative, gradients 2e-3),
  single-frame and for 2 stacked frames; and the JAX package with the skip
  on (Pallas interpret mode) at the same masks, tile 32;
* ``rays.ray_casting``/``pixel_rays_at`` and ``occupancy`` against the JAX
  modules, on the single-box scene of ``tests/test_rendering.py`` through
  the twin field, to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.models import box_parameters as jbox
from vsrd_tpu.pipeline import frame as jfm, optimize as jopt, sharded as jsh
from vsrd_tpu.rendering import fused_field as ff
from vsrd_tpu.rendering import occupancy as jocc, pallas_field as pf, rays as jrays
from vsrd_tpu.rendering import renderer as jrenderer, scene as jscene
from vsrd_tpu_torch.models import box_parameters as tbox
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt, sharded as tsh
from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import fused_field as tff
from vsrd_tpu_torch.rendering import occupancy as tocc, rays as trays, renderer as trenderer
from vsrd_tpu_torch.rendering import scene as tscene
from vsrd_tpu_torch.utils import convert

from test_group_skip import _points, _scene
from torch_mxu import port_unrounded

torch.set_num_threads(2)
TILE = 32
TAU = 0.25


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_mask(pos, loc, half, valid, threshold, tile=TILE):
    """The JAX package's mask on N padded to a multiple of 8 with invalid
    slots (as its optimize.py pads the scene)."""
    n = loc.shape[0]
    pad = -(-n // 8) * 8 - n
    loc = np.concatenate([np.asarray(loc), np.zeros((pad, 3), np.float32)])
    half = np.concatenate([np.asarray(half), np.ones((pad, 3), np.float32)])
    valid = np.concatenate([np.asarray(valid), np.zeros(pad, np.float32)])
    return np.asarray(ff.group_tile_mask(jnp.asarray(pos), jnp.asarray(loc), jnp.asarray(half),
                                         jnp.asarray(valid), threshold, tile=tile,
                                         g_size=ff.group_size_of(n + pad)))


def _port_mask(pos, loc, half, valid, threshold, tile=TILE):
    return tff.group_tile_mask(_t(pos), _t(loc), _t(half), _t(valid), threshold, tile).numpy()


# ---------------------------------------------------------------- the mask

@pytest.mark.parametrize("n", [16, 12])
@pytest.mark.parametrize("p", [96, 70])
@pytest.mark.parametrize("threshold", [1.0, 5.0, 10.0, 80.0])
def test_group_tile_mask_matches_jax(n, p, threshold):
    """Entry for entry, with points around both groups (the first half of
    the points moved 60 m down +z), the last slot invalid, P = 70 not a
    multiple of the tile; N = 12 (a partial last group) against JAX's 16."""
    loc, _, half, valid, _ = (np.asarray(a) for a in _scene(16))
    loc, half, valid = loc[:n], half[:n], valid[:n].copy()
    valid[-1] = 0.0
    pos = np.asarray(_points(p)).copy()
    pos[: p // 2, 2] += 60.0
    want = _jax_mask(pos, loc, half, valid, threshold)
    got = _port_mask(pos, loc, half, valid, threshold)
    assert got.dtype == np.int32 and got.shape == (2, -(-p // TILE))
    np.testing.assert_array_equal(got, want)


def test_group_tile_mask_drops_the_far_group_and_keeps_all_without_valid_instances():
    loc, _, half, valid, _ = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(96))                      # near group 0; group 1 at z ~ +60
    threshold = 2.0 + 12.0 * TAU
    got = _port_mask(pos, loc, half, valid, threshold)
    np.testing.assert_array_equal(got, _jax_mask(pos, loc, half, valid, threshold))
    np.testing.assert_array_equal(got, [[1, 1, 1], [0, 0, 0]])
    none = np.zeros_like(valid)
    got = _port_mask(pos, loc, half, none, threshold)
    np.testing.assert_array_equal(got, _jax_mask(pos, loc, half, none, threshold))
    assert got.all()                                   # big - big = 0: keep all
    # far from both groups, the nearest one is kept (the first, on a tie)
    far = pos + np.float32([0.0, 0.0, 500.0])
    got = _port_mask(far, loc, half, valid, 1.0)
    np.testing.assert_array_equal(got, _jax_mask(far, loc, half, valid, 1.0))
    np.testing.assert_array_equal(got, [[0, 0, 0], [1, 1, 1]])


def test_group_tile_mask_of_stacked_frames_is_per_frame():
    loc, _, half, valid, _ = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(96))
    frames = dict(pos=np.stack([pos, pos + np.float32([0, 0, 60])]),
                  loc=np.stack([loc, loc]), half=np.stack([half, half]),
                  valid=np.stack([valid, np.zeros_like(valid)]))
    got = tff.group_tile_mask(*(_t(frames[k]) for k in ("pos", "loc", "half", "valid")),
                              torch.tensor(5.0), TILE)
    assert got.shape == (2, 2, 3)
    for f in range(2):
        np.testing.assert_array_equal(
            got[f].numpy(), _jax_mask(frames["pos"][f], loc, half, frames["valid"][f], 5.0))


def test_group_helpers():
    assert [tff.group_size_of(n) for n in (1, 8, 9, 16, 20)] == [1, 8, 8, 8, 8]
    assert [tff.num_groups_of(n) for n in (1, 8, 9, 16, 20)] == [1, 1, 2, 2, 3]
    np.testing.assert_allclose(
        float(tff.group_skip_threshold(torch.tensor(TAU))),
        float(ff.group_skip_threshold(ff.FieldStatics(num_instances=16), TAU)))
    assert tff.SKIP_DISTANCE == ff._SKIP_DISTANCE
    mask = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    keep = tff.point_keep(mask, 5, 12, 3)
    assert keep.shape == (5, 12)
    assert keep[:3, :8].all() and not keep[:3, 8:].any()
    assert not keep[3:, :8].any() and keep[3:, 8:].all()


# ---------------------------------------------------------------- the twins

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pf, "INTERPRET", True)


def _skip_statics():
    return ff.FieldStatics(num_instances=16, field_dtype=None, group_skip=True)


def _cotangents(p=96, n=16, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(p,)).astype(np.float32),
            rng.normal(size=(p, n)).astype(np.float32),
            rng.normal(size=(p, 3)).astype(np.float32))


def _twin_mask(pos, loc, half, valid):
    return tff.group_tile_mask(_t(pos), _t(loc), _t(half), _t(valid),
                               tff.group_skip_threshold(torch.tensor(TAU)), TILE)


def test_masked_twin_matches_pallas_skip_mode(interpret):
    """u, w, grad_x u and the pullback to (loc, half, per-instance weights)
    of the masked twin against the Pallas kernels with ``group_skip``; the
    mask drops the far group, whose weights come out exactly 0."""
    loc, rot, half, valid, w = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(96))
    cu, cw, cg = _cotangents()
    statics = _skip_statics()

    def jax_loss(loc_, half_, w_):
        u, wts, g = pf.fused_field_with_grad(statics, TILE, jnp.asarray(pos), loc_, rot, half_,
                                             valid, ff.build_interleaved_layers(w_), TAU)
        return jnp.sum(u * cu) + jnp.sum(wts * cw) + jnp.sum(g * cg), (u, wts, g)

    (_, (u, wts, g)), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(loc), jnp.asarray(half), jnp.asarray(w))

    mask = _twin_mask(pos, loc, half, valid)
    assert mask[1].sum() == 0
    params = [_t(loc).requires_grad_(), _t(half).requires_grad_(), _t(w).requires_grad_()]
    u2, w2, g2 = tff.scene_eval_with_grad(_t(pos), params[0], _t(rot), params[1], _t(valid),
                                          params[2], torch.tensor(TAU), group_mask=mask,
                                          mask_tile=TILE)
    loss = (u2 * _t(cu)).sum() + (w2 * _t(cw)).sum() + (g2 * _t(cg)).sum()
    got = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(u2.detach().numpy(), np.asarray(u), atol=1e-5)
    np.testing.assert_allclose(w2.detach().numpy(), np.asarray(wts), atol=1e-5)
    np.testing.assert_allclose(g2.detach().numpy(), np.asarray(g), atol=1e-5)
    assert not w2[:, 8:].any() and not np.asarray(wts)[:, 8:].any()
    for a, b in zip(got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)
    assert not got[2][8:].any()                      # the dropped group: exact zeros


def test_masked_dir_twin_matches_pallas_skip_mode(interpret):
    loc, rot, half, valid, w = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(96))
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=pos.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    u, wts, ud = pf.fused_field_dir_forward(_skip_statics(), TILE, jnp.asarray(pos),
                                            jnp.asarray(dirs), loc, rot, half, valid,
                                            ff.build_interleaved_layers(jnp.asarray(w)), TAU)
    mask = _twin_mask(pos, loc, half, valid)
    u2, w2, ud2 = tff.scene_eval_dir(_t(pos), _t(dirs), _t(loc), _t(rot), _t(half), _t(valid),
                                     _t(w), torch.tensor(TAU), group_mask=mask, mask_tile=TILE)
    np.testing.assert_allclose(u2.numpy(), np.asarray(u), atol=1e-5)
    np.testing.assert_allclose(w2.numpy(), np.asarray(wts), atol=1e-5)
    np.testing.assert_allclose(ud2.numpy(), np.asarray(ud), atol=1e-5)


def test_masked_batched_twins_match_pallas_skip_mode(interpret):
    """Two frames with their own masks (frame 1's points next to the far
    group, so it drops the near one): the batched twins against the
    frame-grid Pallas kernels in skip mode."""
    loc, rot, half, valid, w = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(96))
    stack = lambda a, b=None: np.stack([a, a if b is None else b])  # noqa: E731
    x = dict(pos=stack(pos, pos + np.float32([0, 0, 60])), loc=stack(loc), rot=stack(rot),
             half=stack(half), valid=stack(valid), w=stack(w))
    rng = np.random.default_rng(9)
    dirs = rng.normal(size=x["pos"].shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    layers = jax.vmap(ff.build_interleaved_layers)(jnp.asarray(x["w"]))
    ref = pf.fused_field_with_grad(_skip_statics(), TILE, *(jnp.asarray(x[k]) for k in (
        "pos", "loc", "rot", "half", "valid")), layers, TAU)
    ref_dir = pf.fused_field_dir_forward(_skip_statics(), TILE, jnp.asarray(x["pos"]),
                                         jnp.asarray(dirs), *(jnp.asarray(x[k]) for k in (
                                             "loc", "rot", "half", "valid")), layers, TAU)
    mask = _twin_mask(x["pos"], x["loc"], x["half"], x["valid"])
    np.testing.assert_array_equal(mask[0].numpy(), [[1, 1, 1], [0, 0, 0]])
    np.testing.assert_array_equal(mask[1].numpy(), [[0, 0, 0], [1, 1, 1]])
    args = [_t(x[k]) for k in ("pos", "loc", "rot", "half", "valid", "w")]
    got = tff.scene_eval_with_grad_batched(*args, torch.tensor(TAU), group_mask=mask,
                                           mask_tile=TILE)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    got_dir = tff.scene_eval_dir_batched(args[0], _t(dirs), *args[1:], torch.tensor(TAU),
                                         group_mask=mask, mask_tile=TILE)
    for a, b in zip(got_dir, ref_dir):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_cpu_wrappers_take_the_mask_to_the_twins_and_launchers_refuse_cpu():
    """On CPU tensors the wrappers run the masked twins at MASK_TILE; the
    launchers refuse CPU tensors with or without a mask, launching nothing."""
    loc, rot, half, valid, w = (np.asarray(a) for a in _scene(16))
    pos = np.asarray(_points(300))
    args = [_t(a) for a in (pos, loc, rot, half, valid, w)]
    tau = torch.tensor(TAU)
    mask = fk.group_mask_for(args[0], args[1], args[3], args[4], tau)
    assert mask.shape == (2, -(-300 // fk.MASK_TILE)) and mask.dtype == torch.int32
    a = fk.fused_field_with_grad(*args, tau, group_mask=mask)
    b = tff.scene_eval_with_grad(*args, tau, group_mask=mask, mask_tile=fk.MASK_TILE)
    for s, t in zip(a, b):
        torch.testing.assert_close(s, t, rtol=0, atol=0)
    before = (fk.field_forward.launches, fk.field_forward.skip_launches)
    with pytest.raises(ValueError):
        fk.field_forward(*args, tau, group_mask=mask)
    assert (fk.field_forward.launches, fk.field_forward.skip_launches) == before


# ---------------------------------------------------------------- compute_loss

N, RAYS, SAMPLES = 16, 8, 4
CFG = dict(num_steps=8, warmup_steps=2, num_rays=RAYS, num_samples=SAMPLES, deterministic=True,
           checkpoint_interval=4, metric_interval=4)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", kernel_group_skip=True, **CFG)
KW = dict(num_views=2, image_size=(24, 32), num_instances=N, max_instances=N, layout="kitti")


@pytest.fixture(scope="module")
def loss_setup():
    frames = []
    for scene in (0, 3):
        key = jax.random.PRNGKey(scene)
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        frames.append((jfm.synthetic_frame(key, **KW), tfm.synthetic_frame(seed, **KW,
                                                                           device="cpu")))
    params = jax.device_get(jopt.init_params_batched(jax.random.PRNGKey(1), 2, N, JCFG))
    rays = np.arange(RAYS, dtype=np.int32) * 7
    return frames, params, rays


def _frame_params(params, f):
    return jax.tree.map(lambda a: a[f], params)


def _jax_loss(params, frame, cfg, use_rdf, rays, batched=False):
    def f(p):
        total, aux = jopt.compute_loss(p, frame, jnp.asarray(5), jax.random.PRNGKey(2), cfg,
                                       use_rdf, ray_indices=jnp.asarray(rays))
        return jnp.sum(total), total

    (_, total), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(total), dict(topt.tree_leaves(convert.params_from_jax(
        jax.device_get(grads), device="cpu")))


def _port_loss(params, frame, cfg, use_rdf, rays):
    tp = convert.params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(tp)]
    total, _ = topt.compute_loss(tp, frame, 5, cfg, use_rdf, ray_indices=torch.as_tensor(rays))
    grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
    return total.detach().numpy(), {path: g for (path, _), g in zip(topt.tree_leaves(tp), grads)}


def _assert_close(port, ref, use_rdf):
    (total, grads), (total_ref, grads_ref) = port, ref
    np.testing.assert_allclose(total, total_ref, rtol=1e-4)
    for path, expected in grads_ref.items():
        got = grads[path]
        if not use_rdf and (path[0] == "hyper" or path[-1] == "embeddings"):
            assert got is None and not expected.any(), path
            continue
        b = expected.numpy()
        np.testing.assert_allclose(got.numpy(), b, rtol=2e-3,
                                   atol=2e-4 * max(1.0, float(np.abs(b).max())),
                                   err_msg=str(path))


def test_instance_and_ray_orders_equal_jax(loss_setup):
    """The permutation and the ray order of the skip mode, index for index,
    as the JAX package's optimize.py computes them."""
    frames, params, rays = loss_setup
    (jf, tf) = frames[0]
    p = _frame_params(params, 0)
    jdec = jbox.decode_boxes(p["boxes"])
    tdec = tbox.decode_boxes(convert.params_from_jax(p, device="cpu")["boxes"])
    azimuth = jnp.arctan2(jdec["locations"][:, 0], jdec["locations"][:, 2])
    want = np.asarray(jnp.argsort(jnp.where(jf.valid, azimuth, 1e9)))
    np.testing.assert_array_equal(topt.instance_order(tdec["locations"], tf.valid).numpy(), want)
    # with invalid slots, which tie at the end in index order
    valid = np.asarray(jf.valid).copy()
    valid[[2, 5, 11]] = False
    want = np.asarray(jnp.argsort(jnp.where(jnp.asarray(valid), azimuth, 1e9)))
    np.testing.assert_array_equal(
        topt.instance_order(tdec["locations"], torch.from_numpy(valid)).numpy(), want)
    _, jdirs = jfm.ray_directions_at(jf, jnp.asarray(rays))
    _, tdirs = tfm.ray_directions_at(tf, torch.as_tensor(rays).long())
    want = np.asarray(jnp.argsort(jnp.arctan2(jdirs[..., 0], jdirs[..., 2]), axis=-1))
    got = topt.ray_order(tdirs).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.arange(RAYS))


@pytest.mark.parametrize("use_rdf", [False, True])
def test_compute_loss_with_group_skip_matches_jax_without(loss_setup, use_rdf):
    frames, params, rays = loss_setup
    jf, tf = frames[0]
    p = _frame_params(params, 0)
    _assert_close(_port_loss(p, tf, TCFG, use_rdf, rays),
                  _jax_loss(p, jf, JCFG, use_rdf, rays), use_rdf)


def test_batched_compute_loss_with_group_skip_matches_jax_without(loss_setup):
    """Two stacked frames, each with its own instance order and masks."""
    frames, params, rays = loss_setup
    jfb = jsh.stack_frames([jf for jf, _ in frames])
    tfb = tsh.stack_frames([tf for _, tf in frames])
    both = np.stack([rays, rays])
    _assert_close(_port_loss(params, tfb, TCFG, True, both),
                  _jax_loss(params, jfb, JCFG, True, both), True)


def test_compute_loss_with_group_skip_matches_jax_with_it(loss_setup, monkeypatch):
    """The JAX package's skip mode (Pallas interpret mode, tile 32) against
    the port's at the same tile, so that both build the same masks; both in
    the default mode with f32 products: the JAX package's own on the CPU,
    the port's twins without their bf16 rounding (``torch_mxu``). With the
    skip on, the JAX package's fine gradient takes its three-tangent form,
    whose bf16 rounding the port (one reverse sweep) does not reproduce;
    ``test_torch_precision.py`` holds the port's rounding to the JAX
    package's reverse form."""
    monkeypatch.setattr(pf, "INTERPRET", True)
    monkeypatch.setattr(pf, "pallas_supported", lambda: True)
    monkeypatch.setattr(fk, "MASK_TILE", TILE)
    frames, params, rays = loss_setup
    jf, tf = frames[0]
    p = _frame_params(params, 0)
    jcfg = jopt.OptimizationConfig(**CFG, pallas_group_skip=True, pallas_tile=TILE,
                                   pallas_bwd_tile=TILE, pallas_box_tile=TILE)
    cfg = dataclasses.replace(TCFG, kernel_matmul_precision="default")
    with port_unrounded():
        port = _port_loss(p, tf, cfg, True, rays)
    _assert_close(port, _jax_loss(p, jf, jcfg, True, rays), True)


@pytest.mark.parametrize("batched", [False, True])
def test_optimize_frame_runs_with_group_skip(batched):
    """``optimize_frame`` and ``optimize_frames_batched`` (2 frames, each
    with its own instance order and masks) with the skip on, 12 instances:
    finite scalars of the right shape."""
    frames = [tfm.synthetic_frame(seed, num_views=2, image_size=(24, 32), num_instances=10,
                                  max_instances=12, layout="kitti", device="cpu")
              for seed in (5, 6)]
    cfg = topt.OptimizationConfig(num_steps=3, warmup_steps=1, num_rays=8, num_samples=4,
                                  checkpoint_interval=3, metric_interval=3,
                                  kernel_group_skip=True)
    if batched:
        _, scalars = topt.optimize_frames_batched(tsh.stack_frames(frames), 0, cfg)
    else:
        _, scalars = topt.optimize_frame(frames[0], 0, cfg)
    assert all(np.isfinite(v).all() for v in scalars.values())
    assert scalars["loss"].shape == ((3, 2) if batched else (3,))


# ---------------------------------------------------------------- rays and occupancy

def test_ray_casting_and_pixel_rays_match_jax():
    from vsrd_tpu.ops import geometry

    k = np.asarray([[100.0, 0.0, 32.0], [0.0, 100.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
    e = np.asarray(geometry.expand_to_4x4(geometry.rotation_matrix_y(jnp.asarray(0.3))))
    e = e.copy()
    e[:3, 3] = [1.0, 2.0, 3.0]
    ks, es = np.stack([k, k * 1.1]), np.stack([e, np.eye(4, dtype=np.float32)])
    ks[1, 2, 2] = 1.0
    cam, dirs = jrays.ray_casting((48, 64), jnp.asarray(ks), jnp.asarray(es))
    cam2, dirs2 = trays.ray_casting((48, 64), _t(ks), _t(es))
    assert dirs2.shape == (2, 48, 64, 3) and cam2.shape == (2, 3)
    np.testing.assert_allclose(cam2.numpy(), np.asarray(cam), atol=1e-5)
    np.testing.assert_allclose(dirs2.numpy(), np.asarray(dirs), atol=1e-5)
    flat_d = np.asarray(dirs[0]).reshape(-1, 3)
    flat_o = np.broadcast_to(np.asarray(cam[0]), flat_d.shape)
    idx = np.asarray([0, 5, 700, 48 * 64 - 1])
    o, d = jrays.pixel_rays_at(jnp.asarray(flat_d), jnp.asarray(flat_o), jnp.asarray(idx))
    o2, d2 = trays.pixel_rays_at(_t(flat_d), _t(flat_o), torch.from_numpy(idx))
    np.testing.assert_array_equal(o2.numpy(), np.asarray(o))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d))


def _single_box_scenes(n_pad=3):
    loc = np.zeros((n_pad, 3), np.float32)
    loc[0] = [0.0, 0.0, 5.0]
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (n_pad, 3, 3)).copy()
    half = np.ones((n_pad, 3), np.float32)
    valid = np.arange(n_pad) == 0
    return (jscene.SceneParams(*(jnp.asarray(a) for a in (loc, rot, half, valid))),
            tscene.SceneParams(*(_t(a) for a in (loc, rot, half, valid))))


def _grids(g=16):
    occupancy = np.zeros((g, g, g), bool)
    occupancy[8:12, 6:10, 5:9] = True
    origin, extent = np.float32([-8.0, -8.0, -3.0]), np.float32([16.0, 16.0, 16.0])
    return (jocc.OccupancyGrid(jnp.asarray(occupancy), jnp.asarray(origin), jnp.asarray(extent)),
            tocc.OccupancyGrid(_t(occupancy), _t(origin), _t(extent)))


def test_occupancy_lookup_and_update_match_jax():
    jgrid, tgrid = _grids()
    pos = np.random.default_rng(0).uniform(-10, 14, size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tgrid.lookup(_t(pos)).numpy(),
                                  np.asarray(jgrid.lookup(jnp.asarray(pos))))
    jsc, tsc = _single_box_scenes()
    jfield, tfield = jscene.soft_scene_field(jsc, 0.1), tscene.soft_scene_field(tsc, 0.1)
    jgrid = jocc.update_occupancy_grid(lambda p: jfield(p)[0], jgrid, threshold=1.5)
    tgrid = tocc.update_occupancy_grid(lambda p: tfield(p)[0], tgrid, threshold=1.5)
    assert int(tgrid.occupancy.sum()) > 0
    np.testing.assert_array_equal(tgrid.occupancy.numpy(), np.asarray(jgrid.occupancy))


def test_occupancy_volumetric_rendering_matches_jax():
    """Stratified off, on the single-box scene through the twin field; also
    through a field-with-gradient evaluator (the kernels' entry) and its
    gradient with respect to a box parameter."""
    jsc, tsc = _single_box_scenes()
    jfield, tfield = jscene.soft_scene_field(jsc, 0.1), tscene.soft_scene_field(tsc, 0.1)
    jgrid, tgrid = _grids()
    jgrid = jocc.update_occupancy_grid(lambda p: jfield(p)[0], jgrid, threshold=1.5)
    tgrid = tocc.update_occupancy_grid(lambda p: tfield(p)[0], tgrid, threshold=1.5)
    # origins off the box's axis: a sample at its centre, where the box
    # SDF's max over three equal faces has no gradient, takes (1/3, 1/3,
    # 1/3) in JAX and a single face in torch
    origins = np.tile(np.float32([0.013, -0.021, 0.0]), (3, 1))
    dirs = np.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.1, 0.05, 0.99]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kw = dict(marching_step_size=0.25, num_samples=48, sdf_std_deviation=0.1,
              cosine_ratio=0.5, stratified=False)
    ref = jocc.occupancy_volumetric_rendering(jfield, jgrid, jnp.asarray(origins),
                                              jnp.asarray(dirs), **kw)
    got = tocc.occupancy_volumetric_rendering(tfield, tgrid, _t(origins), _t(dirs), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    assert float(got.features[0, 0]) > 0.8 and float(got.features[1].max()) < 0.1

    loc = tsc.locations.clone().requires_grad_()
    scene_g = tsc._replace(locations=loc)

    def field_with_grad(positions):
        flat = positions.reshape(-1, 3)
        u, w, g = fk.fused_field_with_grad(flat, loc, scene_g.rotations,
                                           scene_g.half_dimensions, scene_g.valid.float(), None,
                                           torch.tensor(0.1))
        return (u.reshape(positions.shape[:-1]), w.reshape(*positions.shape[:-1], -1),
                g.reshape(positions.shape))

    out = tocc.occupancy_volumetric_rendering(None, tgrid, _t(origins), _t(dirs),
                                              field_with_grad=field_with_grad, **kw)
    for a, b in zip(out, got):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)

    def jax_feature(l):
        sc = jsc._replace(locations=l)
        return jocc.occupancy_volumetric_rendering(
            jscene.soft_scene_field(sc, 0.1), jgrid, jnp.asarray(origins), jnp.asarray(dirs),
            **kw).features[0, 0]

    (grad,) = torch.autograd.grad(out.features[0, 0], loc)
    # the valid box (the JAX field's -inf mask gives the padded ones NaN)
    np.testing.assert_allclose(grad[0].numpy(),
                               np.asarray(jax.grad(jax_feature)(jsc.locations))[0], atol=1e-5)
    assert not grad[1:].any()


def test_eval_field_with_grad_matches_jax():
    jsc, tsc = _single_box_scenes()
    jfield, tfield = jscene.soft_scene_field(jsc, 0.1), tscene.soft_scene_field(tsc, 0.1)
    pos = np.random.default_rng(1).normal(size=(4, 5, 3)).astype(np.float32) * 3
    ref = jrenderer.eval_field_with_grad(jfield, jnp.asarray(pos))
    got = trenderer.eval_field_with_grad(tfield, _t(pos))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
