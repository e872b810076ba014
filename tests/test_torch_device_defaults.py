"""The port's entry points run on the card unless the caller asks for
another device: ``device`` defaults to ``"cuda"``, and on a machine
without a card a call that asks for nothing fails instead of running on
the CPU. The initialisers that draw from a generator follow the
generator's device."""

import inspect

import numpy as np
import pytest
import torch

from vsrd_tpu_torch.models import box_parameters, hyper_field
from vsrd_tpu_torch.pipeline import frame, optimize
from vsrd_tpu_torch.utils import convert

SMALL_FRAME = dict(num_views=2, image_size=(16, 24), num_instances=2, max_instances=2)
CFG = optimize.OptimizationConfig(num_features=8, hyper_channels=(8,))


def _frame_arrays():
    f = frame.synthetic_frame(0, **SMALL_FRAME, device="cpu")
    v, n = f.gt_boxes_2d.shape[:2]
    masks = [np.zeros((n, 16, 24), np.float32) for _ in range(v)]
    return (None, masks, f.intrinsics.numpy(), f.extrinsics.numpy(), f.gt_boxes_2d.numpy(),
            f.visible.numpy(), f.valid.numpy(), f.gt_boxes_3d.numpy(),
            f.rectification.numpy(), f.target_index)


CALLS = {
    "build_frame_data": (frame.build_frame_data, _frame_arrays),
    "synthetic_frame": (frame.synthetic_frame, lambda: (0,)),
    "init_params_batched": (optimize.init_params_batched, lambda: (0, 2, 2, CFG)),
    "to_torch_tree": (convert.to_torch_tree, lambda: ({"a": np.ones(3)},)),
    "params_from_jax": (convert.params_from_jax,
                        lambda: ({"boxes": {"x": np.ones(2)}, "hyper": {"layers": []}},)),
    "adam_state_from_jax": (convert.adam_state_from_jax, lambda: ({
        "mu": {"boxes": {"x": np.ones(2)}, "hyper": {"layers": []}},
        "nu": {"boxes": {"x": np.ones(2)}, "hyper": {"layers": []}}, "count": 0},)),
}


def _devices(tree):
    if isinstance(tree, dict):
        return set().union(*(_devices(v) for v in tree.values())) if tree else set()
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(v) for v in tree)) if tree else set()
    if isinstance(tree, torch.Tensor):
        return {tree.device.type}
    if hasattr(tree, "valid"):
        return {tree.valid.device.type}
    return set()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entry_point_defaults_to_the_card(name):
    fn, make_args = CALLS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = make_args()
    if torch.cuda.is_available():
        assert _devices(fn(*args)) == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(*args)


@pytest.mark.parametrize("init", ["init_params", "init_box_parameters", "init_hyper_field"])
def test_initialisers_follow_the_generator(init):
    fn = {"init_params": optimize.init_params,
          "init_box_parameters": box_parameters.init_box_parameters,
          "init_hyper_field": hyper_field.init_hyper_field}[init]
    assert inspect.signature(fn).parameters["device"].default is None
    gen = torch.Generator(device="cpu").manual_seed(0)
    if init == "init_params":
        out = fn(gen, 2, CFG)
    elif init == "init_box_parameters":
        out = fn(gen, 1, 2, 8)
    else:
        out = fn(gen, hyper_in_channels=8, hyper_out_channels_list=(8,))
    assert _devices(out) == {"cpu"}
