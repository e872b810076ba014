"""The port's library modules against the JAX package's: the geometry
helpers, warping and correlation (``ops/``), blocks, Sinkhorn-Knopp and
plane-sweep stereo (``modules/``), the encoders, ``field_apply`` and the
box encoders (``models/``) and ``safe_norm`` (``rendering/sdf.py``).

Inputs come from a numpy seed and go through both packages in float32.
Blocks run on flax-initialized parameters carried over by
``convert.blocks_params_from_jax``, the tensorial encoders on JAX-drawn
grids (``convert.to_torch_tree``).

Tolerances, with their reasons: f32 elementwise 1e-5 relative to the
reference's scale (max(max|ref|, 1e-3)) unless stated beside a test;
gradients the same. The blocks 1e-4: their GroupNorm variance is flax's
E[x^2] - E[x]^2 against torch's two-pass form, and a 3x3x3 and a 3x3
convolution of 288 products each sum in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu import modules as jmodules
from vsrd_tpu.models import box_parameters as jbox, encoders as jenc, hyper_field as jhf
from vsrd_tpu.modules import sinkhorn as jsink, stereo as jstereo
from vsrd_tpu.ops import geometry as jgeo, warping as jwarp
from vsrd_tpu.rendering import sdf as jsdf
from vsrd_tpu_torch import modules as tmodules
from vsrd_tpu_torch.models import box_parameters as tbox, encoders as tenc, hyper_field as thf
from vsrd_tpu_torch.modules import sinkhorn as tsink, stereo as tstereo
from vsrd_tpu_torch.ops import geometry as tgeo, warping as twarp
from vsrd_tpu_torch.rendering import sdf as tsdf
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)
RTOL = 1e-5


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-3)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= rtol, err


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(x):
    return np.asarray(x, np.float32)


def _camera(rng, b):
    k = np.tile(np.asarray([[30.0, 0, 8.0], [0, 30.0, 6.0], [0, 0, 1]], np.float32), (b, 1, 1))
    e = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    e[:, :3, 3] = rng.normal(size=(b, 3)) * 0.1
    angle = rng.normal(size=b) * 0.05
    e[:, 0, 0], e[:, 0, 2] = np.cos(angle), np.sin(angle)
    e[:, 2, 0], e[:, 2, 2] = -np.sin(angle), np.cos(angle)
    return k, e


# ---------------------------------------------------------------- ops/geometry

def _geometry_cases():
    rng = _rng(1)
    axes = rng.normal(size=(4, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    rot = np.asarray(jgeo.rotation_matrix(_f32(axes), _f32(rng.normal(size=4))))
    k, e = _camera(rng, 2)
    coords = np.concatenate([rng.normal(size=(2, 3, 4, 3)) + [0, 0, 5], np.ones((2, 3, 4, 1))], -1)
    ext_x = np.eye(4, dtype=np.float32)
    a = 0.07
    ext_x[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return {
        "expand_to_4x4": (_f32(rng.normal(size=(2, 3, 3))),),
        "skew_symmetric_matrix": (_f32(rng.normal(size=(4, 3))),),
        "rotation_matrix_z": (_f32(rng.normal(size=5)),),
        "rotation_matrix": (_f32(axes), _f32(rng.normal(size=4))),
        "translation_matrix": (_f32(rng.normal(size=(4, 3))),),
        "essential_matrix": (_f32(rot), _f32(rng.normal(size=(4, 3)))),
        "fundamental_matrix": (_f32(rng.normal(size=(2, 3, 3))), k, k * 1.1),
        "homogeneous": (_f32(rng.normal(size=(5, 2))),),
        "projection": (_f32(coords), k[:, None, None], e[:, None, None]),
        "backprojection": (_f32(rng.uniform(2, 9, size=(2, 5, 6))), k, e),
        "boxes_to_corners": (_f32(rng.normal(size=(3, 2, 2))),),
        "rectification_from_extrinsic": (ext_x,),
    }


GEOMETRY = _geometry_cases()


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_function_matches_jax(name):
    args = GEOMETRY[name]
    want = getattr(jgeo, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tgeo, name)(*(_t(a) for a in args))
    _close(got, want)


def test_projection_without_extrinsics_and_backprojection_round_trip():
    rng = _rng(2)
    k, e = _camera(rng, 2)
    depth = _f32(rng.uniform(2, 9, size=(2, 5, 6)))
    coords = tgeo.backprojection(_t(depth), _t(k), _t(e))
    pix = tgeo.projection(coords, _t(k)[:, None, None], _t(e)[:, None, None])
    xs = np.arange(6, dtype=np.float32)[None, None, :].repeat(5, 1)
    _close(pix[..., 0] / pix[..., 2], np.broadcast_to(xs, (2, 5, 6)))
    _close(pix[..., 2], depth)
    _close(tgeo.projection(coords, _t(k)[:, None, None]),
           jgeo.projection(jnp.asarray(coords.numpy()), jnp.asarray(k)[:, None, None]))


# ---------------------------------------------------------------- ops/warping

def _warp_inputs(seed=3, b=2, c=3, h=6, w=8):
    rng = _rng(seed)
    k, e = _camera(rng, b)
    return dict(features=_f32(rng.normal(size=(b, c, h, w))),
                depth=_f32(rng.uniform(3, 8, size=(b, 1, h, w))), k=k, e=e,
                cot=_f32(rng.normal(size=(b, c, h, w))))


@pytest.mark.parametrize("kind", ["backward", "forward"])
def test_warping_and_its_gradients_match_jax(kind):
    x = _warp_inputs()
    jfn = jwarp.backward_warping if kind == "backward" else jwarp.forward_warping
    tfn = twarp.backward_warping if kind == "backward" else twarp.forward_warping

    def jloss(f, d):
        out = jfn(f, d, jnp.asarray(x["k"]), jnp.asarray(x["k"]) * 1.05, jnp.asarray(x["e"]),
                  jnp.eye(4)[None].repeat(2, 0))
        return jnp.sum(out * x["cot"]), out

    (_, want), (gf, gd) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["features"]), jnp.asarray(x["depth"]))
    f, d = _t(x["features"], True), _t(x["depth"], True)
    got = tfn(f, d, _t(x["k"]), _t(x["k"]) * 1.05, _t(x["e"]),
              torch.eye(4)[None].repeat(2, 1, 1))
    _close(got, want)
    got_f, got_d = torch.autograd.grad(torch.sum(got * _t(x["cot"])), (f, d))
    _close(got_f, gf)
    _close(got_d, gd)


def test_grid_splatting_matches_jax_and_float64():
    """The scatter-add against JAX's ``.at[].add`` (f32), and the port's f32
    against its own float64 (its sums go through index_add: 1e-5)."""
    rng = _rng(4)
    features = _f32(rng.normal(size=(2, 3, 5, 7)))
    coords = _f32(rng.uniform(-1, 8, size=(2, 5, 7, 2)))
    want = jwarp.grid_splatting(jnp.asarray(features), jnp.asarray(coords), image_size=(6, 8))
    got = twarp.grid_splatting(_t(features), _t(coords), image_size=(6, 8))
    _close(got, want)
    wide = twarp.grid_splatting(_t(features).double(), _t(coords).double(), image_size=(6, 8))
    _close(got, wide.numpy())


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("keepdims", [False, True])
def test_correlations_match_jax(normalize, keepdims):
    rng = _rng(5)
    a, b = _f32(rng.normal(size=(2, 8, 4, 5))), _f32(rng.normal(size=(2, 8, 4, 5)))
    _close(twarp.correlation(_t(a), _t(b), normalize, keepdims),
           jwarp.correlation(jnp.asarray(a), jnp.asarray(b), normalize, keepdims))
    _close(twarp.groupwise_correlation(_t(a), _t(b), 4, normalize, keepdims),
           jwarp.groupwise_correlation(jnp.asarray(a), jnp.asarray(b), 4, normalize, keepdims))


# ---------------------------------------------------------------- modules/stereo, sinkhorn

def test_plane_sweep_stereo_matches_jax():
    rng = _rng(6)
    b, c, h, w = 1, 4, 12, 16
    k, _ = _camera(rng, b)
    views = []
    for shift in (0.0, -0.4, 0.3):
        e = np.eye(4, dtype=np.float32)[None].copy()
        e[0, 0, 3] = shift
        views.append({"feature_maps": _f32(rng.normal(size=(b, c, h, w))),
                      "intrinsic_matrices": k, "extrinsic_matrices": e, "scale": 1})
    sweep = dict(depth_range=(2.0, 20.0), num_hypotheses=8)
    want = jstereo.PlaneSweepStereo(**sweep)(
        *({key: (jnp.asarray(v) if key != "scale" else v) for key, v in view.items()}
          for view in views))
    got = tstereo.PlaneSweepStereo(**sweep)(
        *({key: (_t(v) if key != "scale" else v) for key, v in view.items()} for view in views))
    assert got.shape == (b, 8, h, w)
    _close(got, want)


def test_spatial_propagation_matches_jax():
    rng = _rng(7)
    inputs = _f32(rng.normal(size=(2, 2, 9, 10)))
    kernels = _f32(rng.normal(size=(2, 2, 3, 3, 9, 10)))
    want = jstereo.SpatialPropagation2d(kernel_size=3, num_steps=5)(jnp.asarray(inputs),
                                                                     jnp.asarray(kernels))
    got = tstereo.SpatialPropagation2d(kernel_size=3, num_steps=5)(_t(inputs), _t(kernels))
    _close(got, want)


def test_sinkhorn_knopp_matches_jax():
    rng = _rng(8)
    cost = _f32(rng.uniform(size=(6, 9)))
    d, s = _f32(rng.uniform(0.5, 1.5, 6)), _f32(rng.uniform(0.5, 1.5, 9))
    want = jsink.sinkhorn_knopp(jnp.asarray(cost), jnp.asarray(d), jnp.asarray(s), 0.5, 40)
    got = tsink.sinkhorn_knopp(_t(cost), _t(d), _t(s), 0.5, 40)
    _close(got, want)


# ---------------------------------------------------------------- modules/blocks

def test_grad_scale_is_identity_with_a_scaled_gradient():
    x = _t(_f32(_rng(9).normal(size=(3, 4))), True)
    y = tmodules.grad_scale(x, 0.25)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(torch.sum(y * 2.0), x)
    (jg,) = jax.grad(lambda a: jnp.sum(jmodules.grad_scale(a, 0.25) * 2.0), argnums=(0,))(
        jnp.asarray(x.detach().numpy()))
    _close(g, jg)


def test_pixel_shuffles_keep_the_jax_channel_order():
    x = _f32(_rng(10).normal(size=(2, 6, 8, 3)))                      # NHWC
    down = jmodules.pixel_unshuffle(jnp.asarray(x), 2)
    got = tmodules.pixel_unshuffle(_t(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(down))
    up = tmodules.pixel_shuffle(got, 2)
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jmodules.pixel_shuffle(down, 2)))
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(), x)


def _flax_block(module, x_nhwc, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    # move GroupNorm off its identity init so the affine matters
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(path))), v.shape)
        if "GroupNorm" in str(path) or "Dense" in str(path) else v, variables)
    return variables, module.apply(variables, jnp.asarray(x_nhwc))


@pytest.mark.parametrize("kind", ["packing", "unpacking"])
def test_packing_blocks_match_flax_on_converted_params(kind):
    rng = _rng(11)
    if kind == "packing":
        x = _f32(rng.normal(size=(2, 8, 12, 8)))
        jblock, tblock = jmodules.PackingBlock(out_channels=32), tmodules.PackingBlock(8, 32)
    else:
        x = _f32(rng.normal(size=(2, 4, 6, 32)))
        jblock, tblock = jmodules.UnpackingBlock(out_channels=8), tmodules.UnpackingBlock(32, 8)
    variables, want = _flax_block(jblock, x)
    tblock.load_state_dict(convert.blocks_params_from_jax(jax.device_get(variables), "cpu"))
    got = tblock(_t(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want, rtol=1e-4)


def test_squeeze_excitation_and_scales_match_flax():
    x = _f32(_rng(12).normal(size=(2, 5, 6, 16)))
    variables, want = _flax_block(jmodules.SqueezeExcitation(squeeze_channels=4), x)
    block = tmodules.SqueezeExcitation(16, 4)
    block.load_state_dict(convert.blocks_params_from_jax(jax.device_get(variables), "cpu"))
    _close(block(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want)
    layer = jmodules.LayerScale(num_channels=16, epsilon=0.1)
    want = layer.apply(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    _close(tmodules.LayerScale(16, 0.1)(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want)
    scale = jmodules.Scale(scale=2.5)
    want = scale.apply(scale.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    _close(tmodules.Scale(2.5)(_t(x)), want)


def test_drop_path_with_the_jax_draw_injected():
    x = _f32(_rng(13).normal(size=(16, 3, 2, 2)))
    block = jmodules.DropPath(drop_prob=0.25)
    want = block.apply({}, jnp.asarray(x), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(3)})
    keep = np.abs(np.asarray(want)).reshape(16, -1).max(-1) > 0
    port = tmodules.DropPath(0.25)
    _close(port(_t(x), deterministic=False, keep=torch.from_numpy(keep)), want)
    assert torch.equal(port(_t(x)), _t(x))
    drawn = port(_t(x), deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = drawn.reshape(16, -1).abs().amax(-1) > 0
    _close(drawn[kept], x[kept.numpy()] / 0.75)


def test_residual_and_sequential():
    x = _t(_f32(_rng(14).normal(size=(2, 3))))
    torch.testing.assert_close(tmodules.Residual(lambda a: a * 2)(x), x * 3)
    seq = tmodules.Sequential([tmodules.Scale(2.0), lambda a: a + 1])
    torch.testing.assert_close(seq(x), x * 2 + 1)
    assert len(list(seq.parameters())) == 1


# ---------------------------------------------------------------- models/

def test_sinusoidal_encoding_matches_jax():
    pos = _f32(_rng(15).normal(size=(5, 3)))
    _close(tenc.sinusoidal_frequencies(6), jenc.sinusoidal_frequencies(6))
    _close(tenc.sinusoidal_encode(_t(pos), 6), jenc.sinusoidal_encode(jnp.asarray(pos), 6))


@pytest.mark.parametrize("kind", ["cp", "vm"])
def test_tensorial_encoders_and_gradients_match_jax(kind):
    init = {"cp": jenc.init_tensorial_cp_encoder, "vm": jenc.init_tensorial_vm_encoder}[kind]
    encode = {"cp": (jenc.tensorial_cp_encode, tenc.tensorial_cp_encode),
              "vm": (jenc.tensorial_vm_encode, tenc.tensorial_vm_encode)}[kind]
    params = jax.device_get(init(jax.random.PRNGKey(0), 6, (9, 7, 5)))
    pos = _f32(_rng(16).uniform(-1, 1, size=(4, 10, 3)))
    cot = _f32(_rng(17).normal(size=(4, 10, 6)))

    def jloss(p, x):
        out = encode[0](p, x)
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(pos))
    tparams = convert.to_torch_tree(params, "cpu")
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tparams)]
    x = _t(pos, True)
    got = encode[1](tparams, x)
    _close(got, want)
    grads = torch.autograd.grad(torch.sum(got * _t(cot)), [*leaves, x])
    for g, w in zip(grads, [*jax.tree.leaves(gp), gx]):
        _close(g, w)


@pytest.mark.parametrize("kind", ["cp", "vm"])
def test_tensorial_encoder_init_shapes_and_scale(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "cp":
        params = tenc.init_tensorial_cp_encoder(gen, 16, (40, 30, 20))
        want = jenc.init_tensorial_cp_encoder(jax.random.PRNGKey(0), 16, (40, 30, 20))
    else:
        params = tenc.init_tensorial_vm_encoder(gen, 16, (40, 30, 20))
        want = jenc.init_tensorial_vm_encoder(jax.random.PRNGKey(0), 16, (40, 30, 20))
    got, want = jax.tree.leaves(params), jax.tree.leaves(want)
    assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]
    values = torch.cat([t.reshape(-1) for t in got])
    assert abs(float(values.std()) - 0.1) < 0.01 and abs(float(values.mean())) < 0.01


@pytest.mark.parametrize("final_channels", [1, 3])
def test_field_apply_matches_jax(final_channels):
    rng = _rng(18)
    _, counts = jhf.field_layer_sizes(48, (16, 16), final_channels)
    weights = _f32(rng.normal(size=(3, sum(counts))) * 0.3)
    feats = _f32(rng.normal(size=(3, 7, 48)))
    want = jhf.field_apply(jnp.asarray(weights), jnp.asarray(feats), 48, (16, 16),
                           final_channels)
    _close(thf.field_apply(_t(weights), _t(feats), 48, (16, 16), final_channels), want)


def test_init_hyper_radiance_field_emits_three_channels():
    params = thf.init_hyper_radiance_field(torch.Generator().manual_seed(0),
                                           hyper_in_channels=8, hyper_out_channels_list=(8,))
    want = jhf.init_hyper_radiance_field(jax.random.PRNGKey(0), hyper_in_channels=8,
                                         hyper_out_channels_list=(8,))
    assert ([tuple(t.shape) for t in jax.tree.leaves(params)]
            == [tuple(w.shape) for w in jax.tree.leaves(want)])
    assert params["layers"][-1]["v"].shape[0] == sum(thf.field_layer_sizes(48, (16,) * 4, 3)[1])


@pytest.mark.parametrize("name", ["encode_box_3d", "encode_box_3d_yaw"])
def test_box_encoders_match_jax(name):
    rng = _rng(19)
    loc = _f32(rng.normal(size=(5, 3)) * 4)
    dims = _f32(rng.uniform(0.5, 2.0, size=(5, 3)))
    yaw = _f32(rng.uniform(-3, 3, size=5))
    rot = np.asarray(jgeo.rotation_matrix_y(jnp.asarray(yaw)))
    boxes = np.asarray(jbox.decode_box_3d(jnp.asarray(loc), jnp.asarray(dims), jnp.asarray(rot)))
    want = getattr(jbox, name)(jnp.asarray(boxes))
    got = getattr(tbox, name)(_t(boxes))
    for g, w in zip(got, want):
        _close(g, w)
    if name == "encode_box_3d":
        _close(got[1], dims)
        _close(tbox.decode_box_3d(*got[:2], got[2]), boxes)


def test_safe_norm_matches_jax():
    x = _f32(_rng(20).normal(size=(4, 5, 3)))
    for kw in (dict(), dict(axis=1, keepdims=True)):
        want = jsdf.safe_norm(jnp.asarray(x), **kw)
        got = tsdf.safe_norm(_t(x), **({"dim": kw["axis"], "keepdim": True} if kw else {}))
        _close(got, want)
    assert math.isclose(float(tsdf.safe_norm(torch.zeros(3))), math.sqrt(1e-6), rel_tol=1e-6)


def test_flax_module_names_the_converter_knows():
    """The converter refuses what it does not know instead of guessing."""
    with pytest.raises(ValueError):
        convert.blocks_params_from_jax({"params": {"BatchNorm_0": {"scale": np.ones(2)}}}, "cpu")
