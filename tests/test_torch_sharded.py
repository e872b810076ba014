"""The port's dp x sp sharded step (``vsrd_tpu_torch/pipeline/sharded.py``)
on four gloo processes, against the port's single-process step and the
JAX package's ``make_sharded_train_step`` on four virtual CPU devices.

Sizes are the JAX package's sp-equivalence setup (``tests/test_pipeline.py``):
two frames of 2 views at 32x48, 32 rays, 8 samples, ``deterministic=True``,
warmup 2, a fixed ray schedule, strict mode (field in f32, matmul precision
'highest'), each process's one frame at dp=2 x sp=2. The states come from
single-process port steps (steps 0, and 0-2), so the compared step starts
past the step-0 tie of identical boxes.

Tolerances, with their reasons:
* sharded against single-process, both the port: the scalars in the
  box-only phase 2e-4 relative (the JAX test's bound); in the residual
  phase 1e-5 relative: every process runs the same per-ray arithmetic, and
  the only difference is the order of the sums over rays (two partial
  sums and an all-reduce), a few ulps. The params after the step and the
  sp-averaged gradients 1e-5 relative to each leaf's scale. Measured on
  the CPU: scalars 1.0e-7 in both phases, gradients 8.0e-8 box-only and
  1.1e-6 residual, params 9.3e-8 and 2.3e-6. A collective that does not
  carry the cotangent back (a plain all-reduce of the numerators) gives
  half the ray-local terms' gradient and fails both phases.
* the residual-phase losses and sp-averaged gradients with the photometric
  branch on (its average over sp) and with group skip on (each rank sorts
  its own ray slice), from ``init_sharded_state``'s params: 1e-5, as above.
* the port's sharded scalars against JAX's sharded step: the single-step
  parity tolerances of ``tests/test_torch_optimize.py``, 1e-5 relative;
  the eikonal term to 2e-5 sqrt(eikonal) (``tests/test_torch_batched.py``:
  the JAX field's GELU uses a rational erf).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import frame as jfm, optimize as jopt, sharded as jsh
from vsrd_tpu_torch.models import box_parameters as tbox
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt, photometric as tpm
from vsrd_tpu_torch.pipeline import sharded as tsh
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
TINY = dict(num_views=2, image_size=(32, 48), num_instances=2, max_instances=3)
CFG = dict(num_steps=4, warmup_steps=2, num_rays=32, num_samples=8, deterministic=True,
           metric_interval=2)
JCFG = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
FRAMES = 2
PHASES = (1, CFG["warmup_steps"] + 1)          # box-only and residual
SEED = 99
NAMES = ("loss", "silhouette_loss", "eikonal_loss", "iou_projection_loss",
         "l1_projection_loss")
# residual-phase losses and gradients from init_sharded_state's params in
# two modes that touch the sp path: the photometric branch (its loss
# averaged over sp; the same surface pixels, drawn from the target view's
# masks, injected on every rank, so the average must equal the
# single-process loss; the boxes put at the ground truth's centres and the
# params of seed 1, with which surfels converge through the residual field
# in both scenes) and group skip (each rank azimuth-sorts its own slice of
# the rays; 10 instances spread out)
VARIANTS = {
    "photometric": dict(frame=dict(TINY, with_images=True), scenes=1, init_seed=1,
                        cfg=dict(photometric_weight=0.5, surface_num_rays=16,
                                 surface_num_iterations=60)),
    "group skip": dict(frame=dict(TINY, num_instances=9, max_instances=10, layout="kitti"),
                       scenes=0, init_seed=0, cfg=dict(kernel_group_skip=True)),
}


def _seed(i):
    return int(jax.random.randint(jax.random.PRNGKey(i), (), 0, 2**31 - 1))


def _flat(tree, prefix):
    return {prefix + "/".join(map(str, path)): t.detach().numpy().copy()
            for path, t in topt.tree_leaves(tree)}


# Each process reads the states the test saved, takes its frame and its
# slice of the rays, and saves its sp-averaged gradients, scalars and
# params after one step of each phase; also its place in the mesh.
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt, sharded as tsh

torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
TINY, CFG, PHASES, SEED, FRAMES, SEEDS, VARIANTS, SURFACE, CENTRES = eval(sys.argv[4])
TCFG = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank)
out = {}
try:
    tsh.make_groups(dp=3, sp=2)
except ValueError:
    out["refused"] = np.asarray(True)
groups = tsh.make_groups(dp=2, sp=2)
out["layout"] = np.asarray([groups.dp_index, groups.sp_index,
                            *dist.get_process_group_ranks(groups.sp_group)])
data = np.load(path + "/inputs.npz")
local = groups.frame_range(FRAMES)
frames = tsh.stack_frames([tfm.synthetic_frame(SEEDS[f], **TINY, device="cpu") for f in local])
rays = torch.from_numpy(data["schedule"][local.start:local.stop])
like = topt.init_params(torch.Generator().manual_seed(0), TINY["max_instances"], TCFG)


def load(prefix, tree, path=()):
    if isinstance(tree, dict):
        return {k: load(prefix, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [load(prefix, v, path + (i,)) for i, v in enumerate(tree)]
    return torch.from_numpy(np.stack([data[f"{prefix}{f}/" + "/".join(map(str, path))]
                                      for f in local]))


def flat(tree, prefix):
    return {prefix + "/".join(map(str, p)): t.detach().numpy() for p, t in topt.tree_leaves(tree)}


step_fn = tsh.make_sharded_train_step(groups, TCFG)
for step in PHASES:
    params = load(f"state{step}/params/", like)
    opt_state = {k: load(f"state{step}/{k}/", like) for k in ("mu", "nu")}
    opt_state["count"] = int(data[f"state{step}/count"])
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
    total, _ = topt.compute_loss(params, frames, step, TCFG, step >= TCFG.warmup_steps,
                                 ray_indices=rays, sp_group=groups.sp_group)
    grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
    grads = topt.sp_mean_gradients(grads, groups.sp_group)
    for leaf in leaves:
        leaf.requires_grad_(False)
    for (p, _), g in zip(topt.tree_leaves(params), grads):
        if g is not None:
            out[f"grad{step}/" + "/".join(map(str, p))] = g.numpy()
    scalars = step_fn(params, opt_state, frames, step, SEED, ray_indices=rays)
    out.update({f"scalar{step}/{k}": v.numpy() for k, v in scalars.items()})
    out.update(flat(params, f"params{step}/"))
for name, variant in VARIANTS.items():
    cfg = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG, **variant["cfg"])
    vframes = tsh.stack_frames([tfm.synthetic_frame(SEEDS[f + variant["scenes"]],
                                                    **variant["frame"], device="cpu")
                                for f in local])
    params, _ = tsh.init_sharded_state(variant["init_seed"], FRAMES,
                                       variant["frame"]["max_instances"], cfg, groups,
                                       device="cpu")
    if name == "photometric":
        params["boxes"]["locations"] = torch.tensor(CENTRES)[local.start:local.stop]
    leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
    total, aux = topt.compute_loss(
        params, vframes, PHASES[-1], cfg, True, ray_indices=rays, sp_group=groups.sp_group,
        surface_indices=torch.as_tensor(SURFACE)[local.start:local.stop])
    grads = topt.sp_mean_gradients(torch.autograd.grad(total.sum(), leaves, allow_unused=True),
                                   groups.sp_group)
    out.update({f"{name}/loss/{k}": v.detach().numpy() for k, v in aux["losses"].items()})
    for (p, _), g in zip(topt.tree_leaves(params), grads):
        out[f"{name}/grad/" + "/".join(map(str, p))] = g.numpy()
np.savez(f"{path}/rank{rank}.npz", **out)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else float(np.abs(a).max())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Single-process port states and steps, then the four processes."""
    path = tmp_path_factory.mktemp("sharded")
    frames = [tfm.synthetic_frame(_seed(f), **TINY, device="cpu") for f in range(FRAMES)]
    v, (h, w) = TINY["num_views"], TINY["image_size"]
    schedule = np.random.default_rng(11).integers(0, v * h * w, size=(FRAMES, CFG["num_rays"]))
    optimizer = topt.Adam(TCFG)
    saved = {"schedule": schedule}
    states, single = {}, {}
    for step in PHASES:
        for f in range(FRAMES):
            gen = torch.Generator().manual_seed(f)
            params = topt.init_params(gen, TINY["max_instances"], TCFG)
            state = optimizer.init(params)
            rays = torch.from_numpy(schedule[f])
            for s in range(step):
                topt.train_step(params, state, frames[f], s, TCFG, optimizer, ray_indices=rays)
            states[step, f] = (topt.tree_map(torch.clone, params),
                               {k: topt.tree_map(torch.clone, state[k]) for k in ("mu", "nu")}
                               | {"count": state["count"]})
            saved.update(_flat(params, f"state{step}/params/{f}/"))
            for key in ("mu", "nu"):
                saved.update(_flat(state[key], f"state{step}/{key}/{f}/"))
            saved[f"state{step}/count"] = np.asarray(state["count"])
            # the single-process gradient and step from this state
            leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
            total, _ = topt.compute_loss(params, frames[f], step, TCFG,
                                         step >= TCFG.warmup_steps, ray_indices=rays)
            grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
            for leaf in leaves:
                leaf.requires_grad_(False)
            scalars = topt.train_step(params, state, frames[f], step, TCFG, optimizer,
                                      ray_indices=rays)
            single[step, f] = (grads, scalars, params)
    np.savez(path / "inputs.npz", **saved)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    surface, centres = _photometric_inputs()
    spec = repr((TINY, CFG, PHASES, SEED, FRAMES, [_seed(f) for f in range(FRAMES + 1)],
                 VARIANTS, surface.tolist(), centres.tolist()))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(path), spec],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(path / f"rank{r}.npz")) for r in range(4)]
    return frames, schedule, states, single, ranks, (surface, centres)


def _photometric_inputs():
    """Per frame of the photometric variant: 16 target-view pixels inside
    its masks, and raw box locations that decode to the ground truth's
    centres (the padded slot's to the camera's)."""
    variant = VARIANTS["photometric"]
    lo, hi = (np.asarray(r, np.float32) for r in tbox.DEFAULT_LOCATION_RANGE)
    surface, centres = [], []
    for f in range(FRAMES):
        frame = tfm.synthetic_frame(_seed(f + variant["scenes"]), **variant["frame"],
                                    device="cpu")
        surface.append(tpm.surface_indices(frame, 16, torch.Generator().manual_seed(f)).numpy())
        centre = np.nan_to_num(frame.gt_boxes_3d.numpy()).mean(-2)
        share = np.clip((centre - lo) / (hi - lo), 1e-3, 1 - 1e-3)
        centres.append(np.log(share) - np.log1p(-share))
    return np.stack(surface), np.stack(centres).astype(np.float32)


def test_make_groups_lays_out_ranks_and_refuses_a_wrong_mesh(setup):
    ranks = setup[4]
    for r, out in enumerate(ranks):
        dp_index, sp_index, *members = out["layout"].tolist()
        assert (dp_index, sp_index) == (r // 2, r % 2)
        assert members == [2 * dp_index, 2 * dp_index + 1]
        assert bool(out["refused"])
    with pytest.raises(ValueError):
        tsh.make_groups(dp=2, sp=1)        # one process here
    groups = tsh.make_groups()
    assert (groups.dp, groups.sp, groups.sp_group) == (1, 1, None)
    assert list(groups.frame_range(3)) == [0, 1, 2]


@pytest.mark.parametrize("step", PHASES)
def test_sharded_step_matches_single_process(setup, step):
    """Scalars, updated params and sp-averaged gradients of each sp rank
    against the single-process step on its frame."""
    _, _, _, single, ranks, _ = setup
    rtol = 2e-4 if step < CFG["warmup_steps"] else 1e-5
    for r, out in enumerate(ranks):
        f = r // 2
        grads, scalars, params = single[step, f]
        for name in NAMES:
            np.testing.assert_allclose(out[f"scalar{step}/{name}"][0],
                                       scalars[name].numpy(), rtol=rtol, atol=1e-7,
                                       err_msg=f"rank {r} {name}")
        for (path, p), g in zip(topt.tree_leaves(params), grads):
            key = "/".join(map(str, path))
            got = out[f"params{step}/" + key][0]
            scale = max(float(np.abs(p.numpy()).max()), 1e-8)
            assert float(np.abs(got - p.numpy()).max()) <= 1e-5 * scale, (r, key)
            if g is None:
                assert f"grad{step}/" + key not in out, (r, key)
            else:
                assert _rel(out[f"grad{step}/" + key][0], g.numpy()) <= 1e-5, (r, key)


def test_sharded_step_matches_jax_sharded_step(setup):
    if len(jax.devices()) < 4:
        pytest.skip("needs four JAX devices (tests/conftest.py gives eight)")
    _, schedule, states, _, ranks, _ = setup
    mesh = jsh.make_mesh(jax.devices()[:4], dp=2, sp=2)
    step_fn = jsh.make_sharded_train_step(mesh, JCFG, with_ray_schedule=True)
    jframes = jsh.stack_frames([jfm.synthetic_frame(jax.random.PRNGKey(f), **TINY)
                                for f in range(FRAMES)])
    for step in PHASES:
        params = [convert.params_to_jax(states[step, f][0]) for f in range(FRAMES)]
        opt_states = [convert.adam_state_to_jax(states[step, f][1]) for f in range(FRAMES)]
        stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
        _, _, scalars = step_fn(stack(params), stack(opt_states), jframes, jnp.asarray(step),
                                jax.random.PRNGKey(SEED), jnp.asarray(schedule, jnp.int32))
        for r in (0, 2):                    # sp index 0 of each dp index
            f = r // 2
            for name in NAMES:
                got = ranks[r][f"scalar{step}/{name}"][0]
                want = np.asarray(scalars[name])[f]
                if name == "eikonal_loss":
                    assert abs(got - want) <= 2e-5 * np.sqrt(want), (step, f, got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8,
                                               err_msg=f"step {step} frame {f} {name}")


def test_sharded_entry_point_runs_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(_free_port()), "-m", "vsrd_tpu_torch.pipeline.sharded",
         "--dp", "1", "--sp", "2", "--backend", "gloo", "--device", "cpu",
         "--num-views", "2", "--height", "32", "--width", "48", "--num-instances", "2",
         "--num-rays", "16", "--num-samples", "4", "--frames-per-rank", "1",
         "--warmup-steps", "1", "--residual-steps", "1"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    import json
    records = [json.loads(line) for line in lines]
    assert [r["phase"] for r in records] == ["warmup", "residual"]
    assert all(len(r["loss"]) == 1 and np.isfinite(r["loss"][0]) for r in records)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_sharded_loss_and_gradients_match_single_process_in(setup, name):
    """The residual-phase losses and sp-averaged gradients of each sp rank,
    from ``init_sharded_state``'s params, against the single-process loss
    on its frame from ``init_params_batched``'s (the same draws), with the
    photometric branch (its average over sp) or group skip (each rank sorts
    its own rays) on; 1e-5 of each scale, as the main test."""
    _, schedule, _, _, ranks, (surface, centres) = setup
    variant = VARIANTS[name]
    cfg = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG, **variant["cfg"])
    n = variant["frame"]["max_instances"]
    params_all = topt.init_params_batched(variant["init_seed"], FRAMES, n, cfg, device="cpu")
    for f in range(FRAMES):
        frame = tfm.synthetic_frame(_seed(f + variant["scenes"]), **variant["frame"],
                                    device="cpu")
        params = topt.tree_map(lambda t: t[f].clone(), params_all)
        if name == "photometric":
            params["boxes"]["locations"] = torch.from_numpy(centres[f])
        leaves = [t.requires_grad_() for _, t in topt.tree_leaves(params)]
        total, aux = topt.compute_loss(params, frame, PHASES[-1], cfg, True,
                                       ray_indices=torch.from_numpy(schedule[f]),
                                       surface_indices=torch.from_numpy(surface[f]))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        if name == "photometric":
            assert float(aux["losses"]["photometric_loss"].detach()) > 0
        for r in (2 * f, 2 * f + 1):
            out = ranks[r]
            for key, value in aux["losses"].items():
                np.testing.assert_allclose(out[f"{name}/loss/{key}"][0], value.detach().numpy(),
                                           rtol=1e-5, atol=1e-8, err_msg=f"rank {r} {key}")
            for (path, _), g in zip(topt.tree_leaves(params), grads):
                got = out[f"{name}/grad/" + "/".join(map(str, path))][0]
                assert _rel(got, g.numpy()) <= 1e-5, (r, path)
