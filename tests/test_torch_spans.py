"""The stage spans inside the port's step (``vsrd_tpu_torch/utils/spans.py``).

On the CPU at a cut size: without a profiler ``span`` is one shared no-op
and a chunk computes bit for bit what it computes under the profiler;
under ``torch.profiler`` every operator of a step lies inside exactly one
stage span, the stages are ``spans.STAGES``, and the field kernels'
wrappers keep their range names.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt, sharded
from vsrd_tpu_torch.rendering import field_kernels
from vsrd_tpu_torch.utils import spans

torch.set_num_threads(2)

# a chunk from the last warmup step into the residual phase, over a metric step
CFG = opt.OptimizationConfig(num_steps=8, warmup_steps=2, num_rays=8, num_samples=4,
                             metric_interval=3)
START, STEPS = 1, 3
FIELD_RANGES = ("field_kernels.fused_field_with_grad", "field_kernels.fused_field_dir_forward",
                "field_kernels.field_backward")


def make_state(frames: int):
    kw = dict(num_views=2, image_size=(24, 32), num_instances=2, max_instances=2, device="cpu")
    if frames == 1:
        frame = fm.synthetic_frame(0, **kw)
        params = opt.init_params(torch.Generator().manual_seed(1), 2, CFG)
    else:
        frame = sharded.stack_frames([fm.synthetic_frame(i, **kw) for i in range(frames)])
        params = opt.init_params_batched(1, frames, 2, CFG, device="cpu")
    optimizer = opt.Adam(CFG)
    return frame, params, optimizer.init(params), optimizer


def run_chunk(frames: int, profiled: bool):
    frame, params, state, optimizer = make_state(frames)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            scalars = opt.optimize_chunk(params, state, frame, 5, START, CFG, STEPS, optimizer)
    else:
        prof = None
        scalars = opt.optimize_chunk(params, state, frame, 5, START, CFG, STEPS, optimizer)
    return scalars, params, state, prof


def host_ranges(prof, names):
    return [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name in names]


def inside(event, outer) -> bool:
    return (event.thread == outer.thread and outer.time_range.start <= event.time_range.start
            and event.time_range.end <= outer.time_range.end)


def test_without_a_profiler_span_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("vsrd.boxes") is spans.span(spans.STEP) is spans.OFF
    with spans.span("vsrd.render") as entered:
        assert entered is None


def test_under_a_profiler_span_is_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        made = spans.span(spans.STEP)
        assert made is not spans.OFF
        with made:
            torch.ones(3).add_(1.0)
    assert [e.name for e in host_ranges(prof, {spans.STEP})] == [spans.STEP]


def test_stages_are_named_and_explained():
    assert spans.STAGES == ("vsrd.boxes", "vsrd.rays", "vsrd.render", "vsrd.backward",
                            "vsrd.adam", "vsrd.report")
    assert all(spans.STAGE_MEANINGS[stage] for stage in spans.STAGES)
    assert spans.STEP not in spans.STAGES


@pytest.mark.parametrize("frames", [1, 2])
def test_a_chunk_is_bit_identical_under_the_profiler(frames):
    plain = run_chunk(frames, profiled=False)
    traced = run_chunk(frames, profiled=True)
    assert set(plain[0]) == set(traced[0])
    for name in plain[0]:
        np.testing.assert_array_equal(plain[0][name], traced[0][name], err_msg=name)
    for a_tree, b_tree in zip((plain[1], plain[2]["mu"], plain[2]["nu"]),
                              (traced[1], traced[2]["mu"], traced[2]["nu"])):
        for (path, a), (_, b) in zip(opt.tree_leaves(a_tree), opt.tree_leaves(b_tree)):
            assert torch.equal(a, b), path
    assert plain[2]["count"] == traced[2]["count"] == STEPS


@pytest.mark.parametrize("frames", [1, 2])
def test_every_operator_of_a_step_lies_in_exactly_one_stage(frames):
    prof = run_chunk(frames, profiled=True)[3]
    steps = host_ranges(prof, {spans.STEP})
    stages = host_ranges(prof, set(spans.STAGES))
    assert len(steps) == STEPS
    assert {s.name for s in stages} == set(spans.STAGES)
    operators = [e for e in prof.events()
                 if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    counted = 0
    for step in steps:
        inner = [s for s in stages if inside(s, step)]
        # the backward's switches before the loss, then its gradients
        assert sorted(s.name for s in inner) == sorted(spans.STAGES + ("vsrd.backward",))
        for op in operators:
            if inside(op, step):
                counted += 1
                assert sum(inside(op, s) for s in inner) == 1, op.name
    assert counted > 100 * STEPS
    # outside the steps: the chunk's stack and copy of its scalars, once
    outside = [s for s in stages if not any(inside(s, step) for step in steps)]
    assert [s.name for s in outside] == ["vsrd.report"]


def test_the_field_kernels_ranges_keep_their_names(monkeypatch):
    prof = run_chunk(1, profiled=True)[3]
    # the forwards on the CPU's twins
    assert set(FIELD_RANGES[:2]) <= {e.name for e in prof.events()}
    # the card's autograd function, its launchers replaced by shapes alone
    points, n = 5, 2

    def forward(positions, locations, *rest):
        return (positions.new_zeros(points), positions.new_zeros(points, n),
                positions.new_zeros(points, 3))

    def backward(positions, locations, rotations, half_dims, valid, weights, *rest):
        return (torch.zeros_like(locations), torch.zeros_like(rotations),
                torch.zeros_like(half_dims), None)

    monkeypatch.setattr(field_kernels, "field_forward", forward)
    monkeypatch.setattr(field_kernels, "field_backward", backward)
    locations = torch.zeros(n, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        u, w, g = field_kernels._FusedFieldWithGrad.apply(
            torch.zeros(points, 3), locations, torch.zeros(n, 3, 3), torch.ones(n, 3),
            torch.ones(n), None, torch.tensor(1.0), 100.0, None, "default")
        (u.sum() + w.sum() + g.sum()).backward()
    assert FIELD_RANGES[2] in {e.name for e in prof.events()}
