"""The port's model utilities (``vsrd_tpu_torch/utils/model.py``) against
the JAX package's, and its watchdog (``utils/watchdog.py``).

Inputs come from a numpy seed; tolerances are 1e-6 relative for the
elementwise updates (the same f32 operations) and 1e-5 for the power
iteration and the fused weights (sums of products in another order).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsrd_tpu.utils import model as jmodel
from vsrd_tpu_torch.pipeline import optimize as topt
from vsrd_tpu_torch.utils import convert, model as tmodel, watchdog

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def _tree(rng):
    return {"boxes": {"locations": rng.normal(size=(3, 3)).astype(np.float32),
                      "embeddings": rng.normal(size=(3, 4)).astype(np.float32)},
            "hyper": {"layers": [{"v": rng.normal(size=(2, 4)).astype(np.float32),
                                  "b": rng.normal(size=2).astype(np.float32)}]}}


def _leaves_close(got, want, rtol):
    want = dict(topt.tree_leaves(convert.to_torch_tree(want, "cpu")))
    for path, value in topt.tree_leaves(got):
        np.testing.assert_allclose(value.numpy(), want[path].numpy(), rtol=rtol, atol=1e-7,
                                   err_msg=str(path))


def test_ema_and_average_updates_match_jax():
    rng = np.random.default_rng(0)
    ema, params = _tree(rng), _tree(rng)
    got = tmodel.ema_update(convert.to_torch_tree(ema, "cpu"),
                            convert.to_torch_tree(params, "cpu"), decay=0.9)
    _leaves_close(got, jax.device_get(jmodel.ema_update(ema, params, decay=0.9)), 1e-6)
    got, count = tmodel.average_update(convert.to_torch_tree(ema, "cpu"),
                                       convert.to_torch_tree(params, "cpu"), 3)
    want, want_count = jmodel.average_update(ema, params, 3)
    assert count == int(want_count) == 4
    _leaves_close(got, jax.device_get(want), 1e-6)


def test_freeze_mask_matches_jax():
    params = _tree(np.random.default_rng(1))
    got = tmodel.freeze_mask(convert.to_torch_tree(params, "cpu"),
                             lambda path, leaf: path[0] == "boxes" and leaf.shape[-1] == 3)
    want = jmodel.freeze_mask(params, lambda path, leaf: path[0].key == "boxes"
                              and leaf.shape[-1] == 3)
    assert got == {"boxes": {"locations": True, "embeddings": False},
                   "hyper": {"layers": [{"v": False, "b": False}]}}
    assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_frozen_optimizer_matches_optax_masked_adam():
    """Three steps of the port's Adam (one learning rate, no decay, no
    warmup offset: plain Adam) under the mask against ``optax.adam`` under
    the JAX package's mask: trainable leaves and their moments match,
    frozen leaves and their moments do not move."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    cfg = topt.OptimizationConfig(box_lr=0.05, embedding_lr=0.05, hypernetwork_lr=0.05,
                                  lr_decay=1.0, warmup_steps=0)
    trains = lambda path: path[0] == "boxes" and path[1] == "locations"  # noqa: E731
    jtx = jmodel.frozen_optimizer(optax.adam(0.05), params,
                                  lambda path, leaf: trains(tuple(
                                      getattr(k, "key", getattr(k, "idx", None)) for k in path)))
    jparams, jstate = params, jtx.init(params)
    tparams = convert.to_torch_tree(params, "cpu")
    ttx = tmodel.frozen_optimizer(topt.Adam(cfg), tparams, lambda path, leaf: trains(path))
    tstate = ttx.init(tparams)
    before = {p: t.clone() for p, t in topt.tree_leaves(tparams)}
    for step in range(3):
        grads = _tree(np.random.default_rng(10 + step))
        updates, jstate = jtx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.step(tparams, [t for _, t in topt.tree_leaves(convert.to_torch_tree(grads, "cpu"))],
                 tstate)
    _leaves_close(tparams, jax.device_get(jparams), 1e-5)
    for path, value in topt.tree_leaves(tparams):
        if not trains(path):
            assert torch.equal(value, before[path]), path
    for key in ("mu", "nu"):
        for path, value in topt.tree_leaves(tstate[key]):
            assert bool(value.any()) == trains(path), (key, path)


def test_spectral_normalize_matches_jax():
    w = (np.random.default_rng(3).normal(size=(8, 6)) * 3).astype(np.float32)
    for iterations in (1, 30):
        got = tmodel.spectral_normalize(torch.from_numpy(w), num_iterations=iterations)
        want = jmodel.spectral_normalize(jnp.asarray(w), num_iterations=iterations)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert abs(float(torch.linalg.matrix_norm(got, ord=2)) - 1.0) < 1e-2


@pytest.mark.parametrize("with_bias", [True, False])
def test_fuse_post_norm_matches_jax(with_bias):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32) if with_bias else None
    stats = [rng.uniform(0.5, 2.0, 6).astype(np.float32), rng.normal(size=6).astype(np.float32),
             rng.normal(size=6).astype(np.float32), rng.uniform(0.5, 2.0, 6).astype(np.float32)]
    got = tmodel.fuse_post_norm(torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                                *map(torch.from_numpy, stats))
    want = jmodel.fuse_post_norm(jnp.asarray(w), None if b is None else jnp.asarray(b),
                                 *map(jnp.asarray, stats))
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)


def test_norm_parameter_conversions_match_jax():
    bn = {"scale": np.arange(1, 9, dtype=np.float32), "bias": np.zeros(8, np.float32)}
    tbn = convert.to_torch_tree(bn, "cpu")
    for kw in (dict(num_groups=4), dict(group_size=2)):
        got = tmodel.batch_norm_to_group_norm_params(tbn, **kw)
        want = jmodel.batch_norm_to_group_norm_params(bn, **kw)
        assert got["num_groups"] == want["num_groups"] == 4
        np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    for bad in (dict(), dict(num_groups=4, group_size=2), dict(num_groups=3)):
        with pytest.raises(ValueError):
            tmodel.batch_norm_to_group_norm_params(tbn, **bad)
    got = tmodel.group_norm_to_batch_norm_params(tbn)
    want = jmodel.group_norm_to_batch_norm_params(bn)
    for key in ("scale", "bias", "mean", "var"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


OVERRUN = r"""
import time
from vsrd_tpu_torch.utils.watchdog import deadline
with deadline(0.5, "stuck phase"):
    time.sleep(30)
print("not reached")
"""


def test_deadline_exits_124_with_one_json_line():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    run = subprocess.run([sys.executable, "-c", OVERRUN], env=env, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode == 124
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["phase"] == "stuck phase" and record["timeout_s"] == 0.5


def test_deadline_lets_a_quick_body_through():
    with watchdog.deadline(30, "quick"):
        value = 1 + 1
    assert value == 2


def test_heartbeat_prints(capsys):
    import time
    with watchdog.Heartbeat("long build", interval_s=0.05):
        time.sleep(0.3)
    out = capsys.readouterr().out
    assert "[heartbeat] long build: still running" in out


def test_require_backend_raises_without_a_card():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in watchdog.require_backend(60))
    else:
        with pytest.raises(RuntimeError, match="CUDA init failed"):
            watchdog.require_backend(60)
