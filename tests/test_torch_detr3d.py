"""The port's DETR3D and DeformableDETR3D (``vsrd_tpu_torch/models/detr3d.py``)
against the flax models of the JAX package, with the flax weights carried
across by ``convert.detector_params_from_jax``, at the JAX tests' small size
(8 queries, hidden 32, 4 heads, one encoder layer; two decoder layers, so
that one auxiliary level exists).

The JAX loss matches inside ``vmap``; the tests read its costs and its
``row_to_col`` by routing its solver through a host callback that records
the cost and returns the JAX solver's own answer on it. At initialization
the queries' costs lie within ~1e-7 of each other, so an assignment from a
cost that differs in the last bit may differ: the cost is held within a
tolerance, the port's JV (its CPU twin) on the JAX cost must give the JAX
``row_to_col`` entry for entry, and the losses and gradients are compared
with the JAX assignment injected through ``detr_loss(row_to_col=...)``.

Tolerances: outputs and losses 1e-5 relative to each one's scale (f32 in
another order of operations; the decoded corners reach tens of metres);
gradients 1e-4 of each leaf's scale (sums through GroupNorm and
attention); the cost 1e-5; one AdamW or Adam step 1e-6 relative to the
parameters, which start perturbed so that none is 0 (see ``_check_step``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsrd_tpu.models import detr3d as jdetr
from vsrd_tpu.ops import matching as jmatching
from vsrd_tpu_torch.models import detr3d as tdetr
from vsrd_tpu_torch.ops import matching as tmatching
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(2)
SMALL = dict(num_queries=8, hidden_dim=32, num_encoder_layers=1, num_decoder_layers=2,
             num_heads=4)
HW = (32, 48)
OUT_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-6


def _batch(b=2, n=3, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((b, *hw, 3)).astype(np.float32)
    k = np.asarray([[50.0, 0, hw[1] / 2], [0, 50.0, hw[0] / 2], [0, 0, 1.0]], np.float32)
    boxes = rng.uniform(0.1, 0.5, size=(b, n, 2)).astype(np.float32)
    sizes = rng.uniform(0.1, 0.3, size=(b, n, 2)).astype(np.float32)
    return dict(
        images=images,
        intrinsics=np.broadcast_to(k, (b, 3, 3)).copy(),
        labels=np.zeros((b, n), np.int32),
        boxes_2d=np.concatenate([boxes, boxes + sizes], axis=-1),
        boxes_3d=(rng.normal(size=(b, n, 8, 3)) + 5.0).astype(np.float32),
        valid=np.asarray([[True, True, False], [True, True, True]]),
    )


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _jax_model(deformable):
    return (jdetr.DeformableDETR3D(**SMALL, num_samples=4) if deformable
            else jdetr.DETR3D(**SMALL))


def _torch_model(deformable, flax_params):
    model = tdetr.make_detector("deformable" if deformable else "detr3d", device="cpu", **SMALL,
                                **({"num_samples": 4} if deformable else {}))
    model.load_state_dict(convert.detector_params_from_jax(flax_params, "cpu"))
    return model


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module", params=[False, True], ids=["detr3d", "deformable"])
def setup(request, batch):
    deformable = request.param
    jmodel = _jax_model(deformable)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["images"], batch["intrinsics"])
    params = jax.device_get(params)
    out = jax.jit(lambda p, im, k: jmodel.apply(p, im, k, aux_outputs=True))(
        params, batch["images"], batch["intrinsics"])
    tmodel = _torch_model(deformable, params)
    return types.SimpleNamespace(deformable=deformable, jmodel=jmodel, params=params,
                                 out=jax.device_get(out), tmodel=tmodel)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class RecordingSolver:
    """Stands in for ``vsrd_tpu.ops.matching`` inside the JAX loss: each
    level's costs ``[B, Q, Q]`` go to the host, are recorded, and get the
    JAX solver's own ``row_to_col``."""

    PAD_COST = jmatching.PAD_COST

    def __init__(self):
        self.costs, self.assignments = [], []

    def _solve(self, cost):
        cost = np.asarray(cost)
        rows = np.asarray(jax.vmap(jmatching.linear_sum_assignment)(cost)).astype(np.int32)
        self.costs.append(cost)
        self.assignments.append(rows)
        return rows

    def linear_sum_assignment(self, cost):
        q = cost.shape[-1]
        return jax.pure_callback(self._solve, jax.ShapeDtypeStruct((q,), jnp.int32),
                                 jax.lax.stop_gradient(cost), vmap_method="expand_dims")


def _jax_loss(monkeypatch, outputs, batch, focal):
    solver = RecordingSolver()
    monkeypatch.setattr(jdetr, "matching", solver)
    total, scalars = jax.jit(lambda o: jdetr.detr_loss(
        o, batch["labels"], batch["boxes_2d"], batch["boxes_3d"], batch["valid"],
        focal_matching=focal))(outputs)
    monkeypatch.undo()
    return float(total), {k: float(v) for k, v in scalars.items()}, solver


def _valid_columns(cost, valid):
    """A ``[B, Q, Q]`` cost on the valid target columns, 0 elsewhere: the
    port pads with 0 and the JAX package with ``PAD_COST``, and a uniform pad
    gives the same matching of the valid targets."""
    valid = np.asarray(valid)
    mask = np.zeros(cost.shape, bool)
    mask[:, :, :valid.shape[1]] = valid[:, None, :]
    return np.where(mask, cost, 0.0)


def _recorded(solver, cost, valid):
    """The recorded level whose cost is ``cost``'s on the valid columns (a
    callback's order inside a transformation is not promised): its cost
    and assignment."""
    index = int(np.argmin([np.abs(_valid_columns(c - cost, valid)).max()
                           for c in solver.costs]))
    return solver.costs[index], solver.assignments[index]


def _levels(outputs):
    return [outputs] + list(outputs.get("aux_outputs", []))


def _to_torch(outputs):
    if isinstance(outputs, dict):
        return {k: _to_torch(v) for k, v in outputs.items()}
    if isinstance(outputs, list):
        return [_to_torch(v) for v in outputs]
    return torch.from_numpy(np.asarray(outputs))


@pytest.mark.parametrize("size", [(8, 12), (7, 9)], ids=["even", "odd"])
def test_same_padding_is_flax_same(size):
    """flax's SAME with stride 2 pads (0, 1) on even sizes and (1, 1) on odd
    ones; an impulse at (0, 0) sees the kernel's centre tap on even sizes."""
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x = np.zeros((1, *size, 2), np.float32)
    x[0, 0, 0] = 1.0
    x += rng.normal(size=x.shape).astype(np.float32) * (np.arange(2) == 1)
    conv = nn.Conv(3, (3, 3), strides=(2, 2), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(params, x))
    layer = tdetr.SameConv2d(2, 3, 3, stride=2)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(params["params"]["kernel"]).transpose(
            3, 2, 0, 1)))
        layer.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, -(-size[0] // 2), -(-size[1] // 2), 3)
    assert rel_err(got, want) < OUT_TOL
    even = size[0] % 2 == 0
    assert tdetr.same_padding(size[0], 3, 2) == ((0, 1) if even else (1, 1))
    # and torch's symmetric padding=1 is not it on even sizes
    plain = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), layer.weight,
                                       layer.bias, stride=2, padding=1)
    assert (rel_err(plain.permute(0, 2, 3, 1).detach().numpy(), want) > 1e-3) == even


def test_forward_with_aux_outputs_matches_flax(setup, batch):
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = setup.tmodel(tb["images"], tb["intrinsics"], aux_outputs=True)
    assert len(got["aux_outputs"]) == len(setup.out["aux_outputs"]) == 1
    keys = {"logits", "boxes_2d", "boxes_3d", "locations", "dimensions", "confidences"}
    if setup.deformable:
        keys.add("reference_points")
    assert set(got) - {"aux_outputs"} == keys
    for g, w in zip(_levels(got), _levels(setup.out)):
        for key in keys - {"reference_points"}:
            assert g[key].shape == w[key].shape, key
            assert rel_err(g[key].numpy(), w[key]) < OUT_TOL, key
    if setup.deformable:
        assert rel_err(got["reference_points"].numpy(), setup.out["reference_points"]) < OUT_TOL


@pytest.mark.parametrize("focal", [False, True], ids=["plain", "focal"])
def test_detr_loss_with_aux_levels_matches_jax(setup, batch, focal, monkeypatch):
    total, scalars, solver = _jax_loss(monkeypatch, setup.out, batch, focal)
    assert len(solver.costs) == 2                     # the final level, then aux0
    outputs = _to_torch(setup.out)
    tb = _torch_batch(batch)
    injected = []
    for level in _levels(outputs):
        port_cost = tdetr.matching_cost(level, tb["labels"], tb["boxes_2d"], tb["valid"], focal)
        cost, rows = _recorded(solver, port_cost.numpy(), batch["valid"])
        assert rel_err(_valid_columns(port_cost.numpy(), batch["valid"]),
                       _valid_columns(cost, batch["valid"])) < OUT_TOL
        # the port's JV (CPU twin) on the JAX cost: the JAX assignment exactly
        assert np.array_equal(tmatching.linear_sum_assignment(torch.from_numpy(cost)).numpy(),
                              rows)
        injected.append(torch.from_numpy(rows).long())
    got_total, got = tdetr.detr_loss(outputs, tb["labels"], tb["boxes_2d"], tb["boxes_3d"],
                                     tb["valid"], focal_matching=focal, row_to_col=injected)
    assert set(got) == set(scalars)
    assert {"aux0_class_loss", "aux0_box_loss", "aux0_num_boxes"} <= set(got)
    assert rel_err(float(got_total), total) < OUT_TOL
    for key, value in scalars.items():
        assert rel_err(float(got[key]), value) < OUT_TOL, key


def test_detr_loss_batches_every_level_into_one_solve(setup, batch, monkeypatch):
    """Without an override, the levels' costs go to one JV call of
    ``[levels * B, Q, Q]``, whose rows are each (level, image)'s own JV."""
    outputs = _to_torch(setup.out)
    tb = _torch_batch(batch)
    calls = []
    solve = tmatching.linear_sum_assignment
    monkeypatch.setattr(tmatching, "linear_sum_assignment",
                        lambda cost: calls.append(cost.shape) or solve(cost))
    tdetr.detr_loss(outputs, tb["labels"], tb["boxes_2d"], tb["boxes_3d"], tb["valid"])
    assert calls == [torch.Size([4, 8, 8])]


def _flax_grads(setup, batch, monkeypatch):
    solver = RecordingSolver()
    monkeypatch.setattr(jdetr, "matching", solver)

    def loss_fn(p):
        out = setup.jmodel.apply(p, batch["images"], batch["intrinsics"], aux_outputs=True)
        return jdetr.detr_loss(out, batch["labels"], batch["boxes_2d"], batch["boxes_3d"],
                               batch["valid"])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(setup.params)
    monkeypatch.undo()
    return float(loss), jax.device_get(grads), solver


def test_parameter_gradients_match_jax_grad(setup, batch, monkeypatch):
    loss, grads, solver = _flax_grads(setup, batch, monkeypatch)
    tb = _torch_batch(batch)
    model = setup.tmodel
    model.zero_grad()
    out = model(tb["images"], tb["intrinsics"], aux_outputs=True)
    injected = [torch.from_numpy(_recorded(solver, tdetr.matching_cost(
        level, tb["labels"], tb["boxes_2d"], tb["valid"]).numpy(), batch["valid"])[1]).long()
        for level in _levels(out)]
    total, _ = tdetr.detr_loss(out, tb["labels"], tb["boxes_2d"], tb["boxes_3d"], tb["valid"],
                               row_to_col=injected)
    total.backward()
    assert rel_err(float(total.detach()), loss) < OUT_TOL
    want = convert.detector_params_from_jax(grads, "cpu")
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    largest = max(float(g.abs().max()) for g in want.values())
    for name, grad in want.items():
        got = named[name].grad
        if got is None:                      # the confidence head: no loss reaches it
            assert float(grad.abs().max()) == 0.0, name
            continue
        if name.endswith("key.bias"):
            # zero in exact arithmetic (the softmax ignores a shift shared by
            # every key): both sides hold rounding only
            assert max(float(got.abs().max()), float(grad.abs().max())) <= 1e-5 * largest
            continue
        scale = float(grad.abs().max())
        assert float((got - grad).abs().max()) <= GRAD_TOL * scale, name


def _perturbed(params, seed):
    """Every leaf nonzero (flax starts the biases at 0), so that a step is
    held relative to the parameters it moves."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (np.asarray(p) + rng.normal(scale=0.02, size=p.shape)).astype(
        np.float32), params)


def _check_step(model, want_params):
    """Parameters within STEP_TOL of each leaf's scale. (optax forms the
    bias corrections 1 - b^t in f32, 1 - 0.999f = 0.00099998713, torch in
    double: the first updates differ by 6.4e-6 of themselves, so a leaf that
    starts at 0 would hold that difference alone.)"""
    want = convert.detector_params_from_jax(jax.device_get(want_params), "cpu")
    for name, p in model.named_parameters():
        assert rel_err(p.detach().numpy(), want[name].numpy()) < STEP_TOL, name


def test_one_adamw_step_matches_optax(setup):
    """``create_train_state``'s optimizer: AdamW with decay 1e-4 on every
    leaf, as ``optax.adamw``; torch's default decay (1e-2) would not do."""
    from vsrd_tpu_torch.pipeline import detector_training as tdt

    start = _perturbed(setup.params, 2)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), start)
    tx = optax.adamw(1e-3)
    updates, _ = jax.jit(tx.update)(grads, tx.init(start), start)
    model = _torch_model(setup.deformable, start)
    optimizer = tdt.make_optimizer(model, 1e-3)
    assert optimizer.param_groups[0]["weight_decay"] == 1e-4
    torch_grads = convert.detector_params_from_jax(grads, "cpu")
    for name, p in model.named_parameters():
        p.grad = torch_grads[name]
    optimizer.step()
    _check_step(model, optax.apply_updates(start, updates))


def test_parameter_groups_and_the_multi_lr_optimizer_match_optax(setup):
    labels = jdetr.parameter_group_labels(setup.params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): g
            for path, g in jax.tree_util.tree_flatten_with_path(labels)[0]}
    port = tdetr.parameter_group_labels(setup.tmodel)
    by_module = {name.rsplit(".", 1)[0]: g for name, g in port.items()}
    for path, group in flat.items():
        assert by_module[path.rsplit("/", 1)[0].replace("/", ".")
                         if "/" in path else path] == group, path
    assert set(port.values()) == set(flat.values()) == (
        set(tdetr.PARAMETER_GROUPS) if setup.deformable
        else {"backbone", "heads", "transformer"})

    lrs = {"backbone": 1e-5, "transformer": 1e-4, "heads": 3e-4, "reference_points": 2e-5,
           "sampling_offsets": 5e-5}
    tx = jdetr.make_param_group_optimizer(lrs)
    start = _perturbed(setup.params, 5)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), start)
    updates, _ = jax.jit(tx.update)(grads, tx.init(start), start)
    model = _torch_model(setup.deformable, start)
    optimizer = tdetr.make_param_group_optimizer(model, lrs)
    torch_grads = convert.detector_params_from_jax(grads, "cpu")
    for name, p in model.named_parameters():
        p.grad = torch_grads[name]
    optimizer.step()
    _check_step(model, optax.apply_updates(start, updates))


def test_from_jax_and_to_jax_round_trip(setup):
    state = convert.detector_params_from_jax(setup.params, "cpu")
    assert set(state) == set(setup.tmodel.state_dict())
    back = convert.detector_params_to_jax(setup.tmodel.state_dict(), num_heads=4)
    want = jax.tree_util.tree_flatten_with_path(setup.params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape and np.array_equal(got[path], np.asarray(leaf)), path


def test_num_queries_above_the_jv_cap_raises_on_the_card_path():
    cost = torch.zeros(1, tmatching.JV_MAX_N + 1, tmatching.JV_MAX_N + 1)
    with pytest.raises(ValueError, match=str(tmatching.JV_MAX_N)):
        tmatching.jv_assignment(cost.to("meta"))
