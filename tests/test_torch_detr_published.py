"""The port's published DETR (``PublishedDETR3D``, ``make_detector(arch=
"detr-r50")``) and its training step against the plain reference of the
benchmark's detector cell (``benchmark/detr_reference.py``: plain torch,
float32, scipy's Hungarian matching, no import of the port), on seeded
random weights at the ResNet-50's published widths and a cut transformer
(2 + 2 layers of 256, 10 queries), 64x96 images, batch 2; the frozen stages,
the trained parameter count at full width, and the JV twin above the card
kernel's old cap of 64.

Tolerances: both sides run float32 on the CPU in another order of
operations (a fused scaled-dot-product attention against its written-out
softmax, the norms' folded scale against their formula), so outputs and the
loss agree to 2e-5 of each one's scale and gradients to 2e-4 of each
leaf's largest entry (sums through 16 bottlenecks and 4 attention layers);
one clipped AdamW step moves every trained parameter by about the learning
rate; the median leaf's step agrees to 1e-4 of its norm, and every leaf's
to 5e-2 (the first decoder layer's self-attention output bias meets a
LayerNorm at a zero input: see the test).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import detr_reference as ref  # noqa: E402
from vsrd_tpu_torch.models import detr3d  # noqa: E402
from vsrd_tpu_torch.modules import blocks  # noqa: E402
from vsrd_tpu_torch.ops import matching  # noqa: E402
from vsrd_tpu_torch.pipeline import detector_training as dt  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(num_queries=10, num_encoder_layers=2, num_decoder_layers=2)
CONFIG = {"num_heads": 8, "num_encoder_layers": 2, "num_decoder_layers": 2, "num_classes": 1,
          "matcher": {"class": 1.0, "l1": 5.0, "giou": 2.0},
          "loss": {"class": 1.0, "no_object_weight": 0.1, "l1": 5.0, "giou": 2.0, "box3d": 1.0},
          "optimizer": {"lr": 1e-4, "lr_backbone": 1e-5, "betas": [0.9, 0.999], "eps": 1e-8,
                        "weight_decay": 1e-4, "clip_max_norm": 0.1}}
OUT_TOL, GRAD_TOL, STEP_TOL, WORST_STEP_TOL = 2e-5, 2e-4, 1e-4, 5e-2
COST_TOL = 1e-6     # the same outputs, float32 against float64
PUBLISHED_TRAINED = 41.3e6      # DETR-R50's trained parameters (COCO heads), the paper's count


def _batch(b=2, n=4, hw=(64, 96), seed=0):
    g = torch.Generator().manual_seed(seed)
    corner = torch.rand(b, n, 2, generator=g) * 0.5
    k = torch.tensor([[60.0, 0.0, hw[1] / 2], [0.0, 60.0, hw[0] / 2], [0.0, 0.0, 1.0]])
    return {
        "images": torch.rand(b, *hw, 3, generator=g),
        "intrinsics": k.expand(b, 3, 3).clone(),
        "labels": torch.zeros(b, n, dtype=torch.int32),
        "boxes_2d": torch.cat([corner, corner + 0.1 + 0.3 * torch.rand(b, n, 2, generator=g)], -1),
        "boxes_3d": torch.randn(b, n, 8, 3, generator=g) + torch.tensor([0.0, 1.0, 15.0]),
        "valid": torch.tensor([[True, True, True, False], [True, True, True, True]]),
    }


@pytest.fixture(scope="module")
def model():
    return detr3d.make_detector(arch="detr-r50", seed=7, device="cpu", dropout=0.0, **SMALL)


def _scale_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _port_levels(outputs):
    """The port's levels in decoder order (``detr_loss``'s order is the last
    level first)."""
    return outputs["aux_outputs"] + [outputs]


def test_forward_matches_the_reference_on_every_level(model):
    batch = _batch()
    with torch.no_grad():
        outputs = model(batch["images"], batch["intrinsics"], aux_outputs=True)
        want = ref.forward(dict(model.state_dict()), batch["images"], batch["intrinsics"],
                           CONFIG)
    got = _port_levels(outputs)
    assert len(got) == len(want) == 2
    for level, (g, w) in enumerate(zip(got, want)):
        for key in ("logits", "boxes_2d", "boxes_3d"):
            assert _scale_err(g[key], w[key]) < OUT_TOL, (level, key)


def _solve_levels(outputs, batch):
    costs = torch.cat([detr3d.matching_cost(level, batch["labels"], batch["boxes_2d"],
                                            batch["valid"], giou=True)
                       for level in [outputs] + outputs["aux_outputs"]])
    return costs, matching.linear_sum_assignment(costs)


def test_matching_is_scipys_optimum_on_the_ports_costs(model):
    batch = _batch()
    with torch.no_grad():
        outputs = model(batch["images"], batch["intrinsics"], aux_outputs=True)
    costs, row_to_col = _solve_levels(outputs, batch)
    assert costs.shape == (2 * 2, 10, 10)
    assert ref.hungarian_gap(costs, row_to_col, batch["valid"]) == 0.0
    # a matching that is not the optimum reads above 0
    assert ref.hungarian_gap(costs, torch.arange(10).expand(4, 10), batch["valid"]) > 0.0


def test_matching_cost_is_the_references_and_jv_reaches_its_optimum(model, monkeypatch):
    """The port's matching cost (class 1, L1 5, GIoU 2, the pad 0) against
    the reference's DETR matcher cost in float64 on the same outputs,
    elementwise; the port's assignment is scipy's optimum on the reference's
    cost. A cost without its GIoU term reads far off, and its assignment
    off the optimum."""
    from vsrd_tpu_torch.ops import iou2d
    batch = _batch(seed=4)
    with torch.no_grad():
        outputs = model(batch["images"], batch["intrinsics"], aux_outputs=True)
    levels = [outputs] + outputs["aux_outputs"]
    want = torch.cat([ref.matching_cost(level, batch, CONFIG) for level in levels])
    costs, row_to_col = _solve_levels(outputs, batch)
    assert ref.cost_gap(costs, want) <= COST_TOL
    assert ref.hungarian_gap(want, row_to_col, batch["valid"]) == 0.0
    monkeypatch.setattr(iou2d, "generalized_box_iou", lambda a, b: torch.zeros(
        (*a.shape[:-1], b.shape[-2])))
    wrong, wrong_rows = _solve_levels(outputs, batch)
    assert ref.cost_gap(wrong, want) > 1e4 * COST_TOL
    assert ref.hungarian_gap(want, wrong_rows, batch["valid"]) > 0.0


def test_loss_gradients_and_one_clipped_adamw_step_match_the_reference(model):
    model = detr3d.make_detector(arch="detr-r50", seed=7, device="cpu", dropout=0.0, **SMALL)
    batch = _batch()
    trained = [name for name, p in model.named_parameters() if p.requires_grad]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the program: the loss and its gradient as the step computes them, with
    # its own assignment recorded
    calls = []
    solve = matching.linear_sum_assignment
    matching.linear_sum_assignment = lambda costs: calls.append(solve(costs)) or calls[-1]
    try:
        model_, optimizer = dt.create_train_state(model, 1e-4, "cpu")
        step = dt.make_train_step(model_, optimizer)
        loss, _ = step(batch)
    finally:
        matching.linear_sum_assignment = solve
    params = dict(model.named_parameters())
    (row_to_col,) = calls
    per_level = list(row_to_col.reshape(2, 2, 10).unbind(0))
    assignments = per_level[1:] + per_level[:1]          # decoder order

    # the reference from the same start, with the program's assignment
    p = {k: v.clone() for k, v in start.items()}
    leaves = [p[k].requires_grad_(True) for k in trained]
    levels = ref.forward(p, batch["images"], batch["intrinsics"], CONFIG)
    total = ref.loss(levels, assignments, batch, CONFIG)
    assert abs(float(loss) - float(total)) <= OUT_TOL * abs(float(total))
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    clipped = ref.clip_(grads, CONFIG["optimizer"]["clip_max_norm"])
    for name, g in zip(trained, clipped):
        got = params[name].grad
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got - g).abs().max()) <= GRAD_TOL * scale or float(g.abs().max()) == 0.0, \
            name
    after = ref.follow(start, trained, [batch], [assignments], CONFIG)["params"][0]
    gaps = {}
    for name, want in zip(trained, after):
        moved = float(torch.linalg.vector_norm(want - start[name]))
        err = float(torch.linalg.vector_norm(params[name].detach() - want))
        gaps[name] = err / moved if moved > 0.0 else err     # a zero bias with no gradient
    assert float(np.median(list(gaps.values()))) <= STEP_TOL
    # the first decoder layer's self-attention reads the zero targets, so its
    # output bias alone feeds norm1 at a zero input, where the norm's
    # Jacobian is 1/sqrt(eps): that leaf's gradient is ill-conditioned
    assert max(gaps.values()) <= WORST_STEP_TOL, max(gaps.items(), key=lambda kv: kv[1])


def test_the_stem_and_layer1_take_no_gradient(model):
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.layer1.")) for n in frozen)
    assert all(p.requires_grad for n, p in model.named_parameters()
               if n.startswith(("backbone.layer2", "backbone.layer3", "backbone.layer4")))
    # no norm is a parameter: the frozen norms' statistics and affine terms are buffers
    assert not any(".bn" in n or "downsample.1" in n for n, _ in model.named_parameters())
    optimizer = dt.make_optimizer(model, 1e-4)
    groups = {g["lr"]: g["params"] for g in optimizer.param_groups}
    named = {id(p): n for n, p in model.named_parameters()}
    assert all(named[id(p)].startswith("backbone.layer") for p in groups[1e-5])
    assert not any(named[id(p)].startswith("backbone.") for p in groups[1e-4])
    in_optimizer = {named[id(p)] for g in optimizer.param_groups for p in g["params"]}
    assert not in_optimizer & set(frozen)
    batch = _batch()
    out = model(batch["images"], batch["intrinsics"])
    out["logits"].sum().backward()
    for name, param in model.named_parameters():
        if name in frozen:
            assert param.grad is None, name
    model.zero_grad(set_to_none=True)


def test_calibrated_frozen_norms_normalize_the_calibration_batch():
    model = detr3d.PublishedDETR3D(**SMALL)
    gen = torch.Generator().manual_seed(3)
    model.init_weights_(gen)
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out))
             for m in model.backbone.modules() if type(m).__name__ == "FrozenBatchNorm2d"]
    model.calibrate_(torch.Generator().manual_seed(5))
    for hook in hooks:
        hook.remove()
    assert len(seen) == 53          # a stem norm, 3 per bottleneck, 4 shortcut norms
    last = [m for m in model.backbone.modules() if type(m).__name__ == "FrozenBatchNorm2d"]
    for norm, out in zip(last, seen):
        # each residual branch's last norm at the calibrated branch scale, the rest at 1
        scale = float(norm.weight[0])
        assert float(out.mean(dim=(0, 2, 3)).abs().max()) < 1e-4 * scale
        assert float((out.var(dim=(0, 2, 3), unbiased=False) / scale**2 - 1.0).abs().max()) < 1e-3
    scales = [float(n.weight[0]) for n in last]
    assert sum(s == pytest.approx(blocks.RESIDUAL_BRANCH_SCALE) for s in scales) == 16
    assert sum(s == 1.0 for s in scales) == 53 - 16


def test_trained_parameter_count_at_full_width_is_detr_r50s():
    with torch.device("meta"):
        model = detr3d.PublishedDETR3D()
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert abs(trained - PUBLISHED_TRAINED) <= 0.01 * PUBLISHED_TRAINED, trained
    assert model.num_queries == 100 and len(model.encoder) == len(model.decoder) == 6


def test_sine_positions_are_detrs():
    want = ref.position_embedding(12, 44, 256, "cpu")
    got = detr3d.sine_positions(12, 44, 128)
    assert got.shape == (528, 256)
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.parametrize("n", [65, 100, 128])
def test_jv_twin_above_64_is_scipys_optimum(n):
    """The JV kernel's plain twin at the sizes the card kernel now takes
    (65-128): padded costs as the DETR loss pads them, and a full random
    cost; the same assignment as scipy's on continuous costs."""
    rng = np.random.default_rng(n)
    full = rng.normal(size=(n, n)).astype(np.float32)
    padded = np.zeros((n, n), np.float32)
    padded[:, :n // 3] = full[:, :n // 3]
    for cost in (full, padded):
        got = matching.linear_sum_assignment_twin(torch.from_numpy(cost)).numpy()
        rows, cols = linear_sum_assignment(cost.astype(np.float64))
        want = cost[rows, cols].astype(np.float64).sum()
        assert sorted(got) == list(range(n))
        assert cost[np.arange(n), got].astype(np.float64).sum() == pytest.approx(want, abs=1e-9)
    rows, cols = linear_sum_assignment(full.astype(np.float64))
    got = matching.linear_sum_assignment_twin(torch.from_numpy(full)).numpy()
    assert np.array_equal(got[rows], cols)


def test_a_large_pad_moves_jv_off_the_optimum_and_a_zero_pad_does_not():
    """Why the published recipe pads the matching cost with 0: at the JAX
    package's 1e6 the f32 duals lose the costs' low bits and JV misses
    scipy's optimum on the valid columns; any uniform pad has the same
    optimum, and at 0 JV reaches it."""
    rng = np.random.default_rng(0)
    missed = False
    for _ in range(20):
        n = int(rng.integers(4, 33))
        scores = rng.normal(size=(100, n)).astype(np.float32) * 3
        gaps = {}
        for pad in (matching.PAD_COST, 0.0):
            cost = np.full((100, 100), pad, np.float32)
            cost[:, :n] = scores
            got = matching.linear_sum_assignment_twin(torch.from_numpy(cost))
            valid = torch.ones(1, n, dtype=torch.bool)
            gaps[pad] = ref.hungarian_gap(torch.from_numpy(cost)[None], got[None], valid)
        assert gaps[0.0] == 0.0
        missed |= gaps[matching.PAD_COST] > 0.0
    assert missed
