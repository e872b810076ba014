"""The port's side of the noise-floor trials (``tools/torch_port/noise_floor.py``)
against the JAX package's (``tools/parity/noise_floor.py`` and
``run_parity.py``).

* the committed inits equal a fresh JAX ``init_params(PRNGKey(1 + t))``,
  exactly, for every stored trial;
* the port's scenes 0 and 7 equal ``run_parity.build_scene``'s arrays
  exactly (the soft masks with their bf16 rounding);
* the port's ``ray_schedule`` equals ``run_parity.ray_schedule`` as integers;
* a cut trial (12 steps, 4 of them warmup, strict mode, 64 rays and 8+8
  samples) through ``run_port`` and through ``run_parity.run_ours`` with
  the JAX package's Pallas kernels in interpret mode: the decoded boxes
  within ``BOX_ATOL`` = 1 mm. The two sum f32 products in different orders,
  and the gap grows with the steps: on the CPU it read 3.8e-6 m on scene
  0, 1.14e-4 m on scene 7 (about 30 f32 ulps of its 49 m depth) and
  1.5e-4 m at the full 512 rays and 24+24 samples. One Adam step moves a
  location by about lr x range x sigmoid' = 0.01 x 100 m x 0.25 = 0.25 m
  whatever the gradient's size, so one step taken on a wrong gradient
  shows 250x above the bar, while the rounding stays 7x below it;
* a frame's loss and gradients in a stacked batch of trials equal the
  frame's alone (the batched path sums the frames' losses: no scaling by F),
  and so do its boxes after a cut trial;
* ``--summarize`` over the stored JAX runs, copied in as stand-ins for the
  port's, reproduces the stored summaries' JAX and reference numbers.
"""

import importlib.util
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import optimize as jopt
from vsrd_tpu_torch.pipeline import optimize as topt, sharded
from vsrd_tpu_torch.utils import convert

import make_torch_nf_inputs
from torch_mxu import interpret

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(ROOT, "tools", "parity")
sys.path.insert(0, PARITY)
import run_parity as rp  # noqa: E402


def _load_tool():
    """The port's tool under its own module name (the JAX tool's file is
    also called noise_floor.py)."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_noise_floor", os.path.join(ROOT, "tools", "torch_port", "noise_floor.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


nf = _load_tool()
torch.set_num_threads(2)

BOX_ATOL = 1e-3              # m; see the module docstring
CUT = nf.Recipe(steps=12, warmup=4, rays=64, samples=8)


@pytest.fixture(scope="module")
def inits():
    return nf.load_inits()


@pytest.mark.parametrize("trial", range(make_torch_nf_inputs.NUM_TRIALS))
def test_committed_inits_equal_jax_init_params(inits, trial):
    cfg = jopt.OptimizationConfig()
    want = jax.device_get(jopt.init_params(jax.random.PRNGKey(1 + trial), 3, cfg))
    got = dict(topt.tree_leaves(convert.params_from_jax(inits[trial], device="cpu")))
    want = dict(topt.tree_leaves(convert.params_from_jax(want, device="cpu")))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path].numpy(), value.numpy(), err_msg=str(path))
    # the strict and production configs draw the same shapes
    assert len(inits) == max(nf.TRIALS.values())


@pytest.mark.parametrize("scene", nf.SCENES)
def test_port_scene_equals_run_parity_build_scene(scene):
    recipe = nf.Recipe()
    _, want = rp.build_scene(recipe.views, (recipe.height, recipe.width), recipe.instances,
                             seed=scene)
    frame = nf.build_scene(scene, recipe, "cpu")
    np.testing.assert_array_equal(nf.soft_masks(frame), want["soft_masks"])
    for name in ("intrinsics", "extrinsics", "gt_boxes_2d", "visible", "gt_boxes_3d"):
        np.testing.assert_array_equal(getattr(frame, name).numpy(), want[name], err_msg=name)
    assert frame.image_size == want["image_size"]
    assert int(frame.target_index) == want["target_index"]


@pytest.mark.parametrize("scene, trial", [(0, 0), (7, 3)])
def test_ray_schedule_equals_run_parity(scene, trial):
    recipe = nf.Recipe()
    _, scene_arrays = rp.build_scene(recipe.views, (recipe.height, recipe.width),
                                     recipe.instances, seed=scene)
    want = rp.ray_schedule(scene_arrays, 30, recipe.rays, seed=1234 + 1000 * trial)
    frame = nf.build_scene(scene, recipe, "cpu")
    got = nf.ray_schedule(nf.soft_masks(frame), 30, recipe.rays, seed=nf.schedule_seed(trial))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene, trial", [(0, 0), (7, 1)])
def test_cut_trial_boxes_match_run_ours(inits, scene, trial):
    """12 steps (4 box-only), strict mode, the JAX side through its Pallas
    kernels in interpret mode, as the JAX package's tests run them on the
    CPU."""
    jcfg = jopt.OptimizationConfig(
        num_steps=CUT.steps, warmup_steps=CUT.warmup, num_rays=CUT.rays,
        num_samples=CUT.samples, deterministic=True, pallas_matmul_precision="highest",
        field_dtype=None, metric_interval=CUT.steps, checkpoint_interval=CUT.steps)
    jframe, scene_arrays = rp.build_scene(CUT.views, (CUT.height, CUT.width), CUT.instances,
                                          seed=scene)
    schedule = rp.ray_schedule(scene_arrays, CUT.steps, CUT.rays, seed=1234 + 1000 * trial)
    with interpret():
        _, want = rp.run_ours(jframe, inits[trial], schedule, jcfg)

    frame, port_schedule, init = nf.trial_inputs(scene, trial, CUT, "cpu", inits)
    np.testing.assert_array_equal(port_schedule, schedule)
    got, scalars = nf.run_port([frame], [init], [port_schedule], nf.make_config(CUT, "highest"))
    assert got.shape == (1, CUT.instances, 8, 3)
    assert all(np.isfinite(v).all() for v in scalars.values())
    np.testing.assert_allclose(got[0], want, rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("use_rdf", [False, True])
def test_batched_trial_gradients_equal_single_frame(inits, use_rdf):
    """Two trials of the two scenes stacked, at the production config: each
    frame's loss and gradients equal its single-frame ones, unscaled."""
    cfg = nf.make_config(CUT, "default")
    step = CUT.warmup + 2 if use_rdf else 1
    trials = [(0, 0), (7, 2)]
    inputs = [nf.trial_inputs(s, t, CUT, "cpu", inits) for s, t in trials]

    def loss_and_grads(params, frame, rays):
        leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
        total, _ = topt.compute_loss(params, frame, step, cfg, use_rdf,
                                     ray_indices=torch.as_tensor(rays))
        return total.detach(), torch.autograd.grad(total.sum(), leaves, allow_unused=True)

    batch = sharded.stack_frames([x[0] for x in inputs])
    params = topt.tree_stack([x[2] for x in inputs])
    total_b, grads_b = loss_and_grads(params, batch, np.stack([x[1][step] for x in inputs]))
    for f, (frame, schedule, init) in enumerate(inputs):
        total_s, grads_s = loss_and_grads(init, frame, schedule[step])
        np.testing.assert_allclose(float(total_b[f]), float(total_s), rtol=1e-5)
        for a, b in zip(grads_b, grads_s):
            assert (a is None) == (b is None)
            if b is not None:
                scale = float(b.abs().max())
                assert float((a[f] - b).abs().max()) <= 2e-4 * max(scale, 1e-30)


def test_batched_cut_trials_equal_single_frame_runs(inits):
    """``run_port`` on two trials stacked against each trial alone, 12 steps
    of the production config: the same boxes within BOX_ATOL (on the card
    the two read apart after 1500 steps, as any two summation orders do)."""
    cfg = nf.make_config(CUT, "default")
    inputs = [nf.trial_inputs(s, t, CUT, "cpu", inits) for s, t in [(0, 1), (7, 3)]]
    batched, _ = nf.run_port([x[0] for x in inputs], [x[2] for x in inputs],
                             [x[1] for x in inputs], cfg)
    for f, (frame, schedule, init) in enumerate(inputs):
        single, _ = nf.run_port([frame], [init], [schedule], cfg)
        np.testing.assert_allclose(batched[f], single[0], rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("precision, stored", [("default", "NOISE_FLOOR_prod.json"),
                                               ("highest", "NOISE_FLOOR.json")])
def test_summarize_reproduces_the_stored_summaries(tmp_path, precision, stored):
    """The JAX runs copied in as the port's, in both modes: the JAX and
    reference columns are the stored summary's, the port's gap to JAX 0 and
    its boxes JAX's."""
    runs = tmp_path / "runs"
    runs.mkdir()
    for scene in nf.SCENES:
        for trial in range(nf.TRIALS[precision]):
            for batched in (False, True):
                shutil.copy(nf.jax_run_path(scene, trial, "ours", precision),
                            runs / nf.run_name(scene, trial, precision, batched))
    report = nf.summarize(precision, runs_dir=str(runs), out_dir=str(tmp_path))
    with open(os.path.join(PARITY, stored)) as fh:
        want = json.load(fh)
    assert report["recipe"] == want["recipe"]
    written = json.loads((tmp_path / f"NOISE_FLOOR_port{nf.JAX_TAG[precision]}.json")
                         .read_text())
    assert written == json.loads(json.dumps(report))
    for mode in ("single", "batched"):
        for scene in nf.SCENES:
            got, ref = report["modes"][mode][str(scene)], want["scenes"][str(scene)]
            assert got["trials"] == list(range(nf.TRIALS[precision]))
            assert got["jax_mean_gt_iou_per_trial"] == ref["ours_mean_gt_iou_per_trial"]
            assert got["port_mean_gt_iou_per_trial"] == ref["ours_mean_gt_iou_per_trial"]
            assert got["torch_mean_gt_iou_per_trial"] == ref["torch_mean_gt_iou_per_trial"]
            assert got["torch_self_spread"] == ref["torch_self_spread"]
            assert got["jax_self_spread"] == ref["ours_self_spread"]
            np.testing.assert_allclose(got["torch_self_std"], ref["torch_self_std"], rtol=1e-12)
            np.testing.assert_allclose(got["gap_to_torch"], ref["cross_gap_of_means"],
                                       rtol=1e-12)
            assert got["holds_against_torch"] == ref["contract_at_noise_floor"]
            assert got["bar_torch"] == max(ref["torch_self_spread"], 1e-2)
            # the stored cross IoU came from JAX's box_3d_iou, this from the port's
            np.testing.assert_allclose(got["cross_iou_torch_same_trial"],
                                       ref["cross_iou_same_trial"], atol=1e-5)
            assert got["gap_to_jax"] == 0.0 and got["holds_against_jax"]
            # identical box sets: not 1 everywhere, since both packages'
            # box_3d_iou read a box against itself below 1 where their
            # clipped polygons' edges coincide (0.4165 for a box of scene 0)
            boxes = [np.asarray(nf.read_json(nf.jax_run_path(scene, t, "ours", precision))
                                ["boxes"]) for t in got["trials"]]
            selves = [rp.matched_iou_3d(b, b)[0].mean() for b in boxes]
            np.testing.assert_allclose(got["cross_iou_jax_same_trial"], selves, atol=1e-5)
