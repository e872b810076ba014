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
from vsrd_tpu_torch.pipeline import frame, optimize, sharded
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
    "init_sharded_state": (sharded.init_sharded_state,
                           lambda: (0, 2, 2, CFG, sharded.make_groups())),
    "to_torch_tree": (convert.to_torch_tree, lambda: ({"a": np.ones(3)},)),
    "params_from_jax": (convert.params_from_jax,
                        lambda: ({"boxes": {"x": np.ones(2)}, "hyper": {"layers": []}},)),
    "detector_params_from_jax": (convert.detector_params_from_jax, lambda: (
        {"params": {"heads": {"classification_head": {"kernel": np.ones((4, 2)),
                                                      "bias": np.zeros(2)}}}},)),
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


def test_the_driver_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``python -m vsrd_tpu_torch.scripts.main`` takes ``--device cuda`` by
    default: without a card it fails before it loads any data."""
    from vsrd_tpu_torch.scripts import main as driver

    config = tmp_path / "configs" / "x" / "config.json"
    config.parent.mkdir(parents=True)
    config.write_text('{"filenames": []}')
    loaded = []
    monkeypatch.setattr(driver, "make_dataset", lambda cfg: loaded.append(cfg) or [])
    if torch.cuda.is_available():
        driver.main(["--config", str(config), "--train"])
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            driver.main(["--config", str(config), "--train"])
        assert not loaded
    driver.main(["--config", str(config), "--train", "--device", "cpu"])
    assert loaded


def test_the_detector_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """``make_detector`` and ``create_train_state`` take ``device="cuda"`` by
    default; without a card a call that asks for nothing fails."""
    from vsrd_tpu_torch.models import detr3d
    from vsrd_tpu_torch.pipeline import detector_training

    small = dict(num_queries=4, hidden_dim=16, num_encoder_layers=1, num_decoder_layers=1,
                 num_heads=2)
    for fn in (detr3d.make_detector, detector_training.create_train_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        model = detr3d.make_detector(**small)
        assert _devices(dict(model.state_dict())) == {"cuda"}
        model, _ = detector_training.create_train_state(detr3d.make_detector(device="cpu",
                                                                             **small))
        assert _devices(dict(model.state_dict())) == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            detr3d.make_detector(**small)
        with pytest.raises((AssertionError, RuntimeError)):
            detector_training.create_train_state(detr3d.make_detector(device="cpu", **small))
    model = detr3d.make_detector(True, device="cpu", **small)
    model, optimizer = detector_training.create_train_state(model, device="cpu")
    assert _devices(dict(model.state_dict())) == {"cpu"}


def test_train_detector_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``python -m vsrd_tpu_torch.scripts.train_detector`` takes ``--device
    cuda`` by default: without a card it fails before it reads any data."""
    from vsrd_tpu_torch.scripts import train_detector

    read = []
    monkeypatch.setattr(train_detector, "build_index", lambda *a: read.append(a) or [])
    argv = ["--root_dirname", str(tmp_path), "--ckpt_dirname", "ckpts/vsrd"]
    assert train_detector.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            train_detector.main(argv)
        assert not read
    with pytest.raises(SystemExit, match="no prediction JSONs"):
        train_detector.main(argv + ["--device", "cpu"])
    assert read


def test_the_sharded_entry_point_runs_on_the_card_with_nccl_by_default():
    args = sharded._parse([])
    assert (args.device, args.backend) == ("cuda", "nccl")


def _library_calls():
    from vsrd_tpu_torch import losses, modules
    from vsrd_tpu_torch.models import encoders
    from vsrd_tpu_torch.ops import warping

    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 2, 6, 8, generator=gen, dtype=torch.float64)
    depth = 2.0 + torch.rand(1, 1, 6, 8, generator=gen, dtype=torch.float64)
    k = torch.tensor([[[20.0, 0, 4], [0, 20.0, 3], [0, 0, 1]]], dtype=torch.float64)
    e = torch.eye(4, dtype=torch.float64)[None]
    view = {"feature_maps": x, "intrinsic_matrices": k, "extrinsic_matrices": e}
    return {
        "backward_warping": lambda: warping.backward_warping(x, depth, k, k, e, e),
        "forward_warping": lambda: warping.forward_warping(x, depth, k, k, e, e),
        "PlaneSweepStereo": lambda: modules.PlaneSweepStereo((2.0, 9.0), 4)(view, view),
        "SpatialPropagation2d": lambda: modules.SpatialPropagation2d(3, 2)(
            x, torch.rand(1, 2, 3, 3, 6, 8, generator=gen, dtype=torch.float64)),
        "sinkhorn_knopp": lambda: modules.sinkhorn_knopp(x[0, 0], x[0, 0, :, 0], x[0, 0, 0]),
        "smoothness_loss": lambda: losses.smoothness_loss(depth, x, reduction="none"),
        "sinusoidal_encode": lambda: encoders.sinusoidal_encode(x[0, 0, :, :3]),
    }


@pytest.mark.parametrize("name", sorted(_library_calls()))
def test_library_functions_follow_their_inputs(name):
    """The library makes no tensor on a device or in a dtype of its own:
    float64 CPU inputs give float64 CPU outputs (as they give CUDA outputs
    for CUDA inputs)."""
    out = _library_calls()[name]()
    assert out.device.type == "cpu" and out.dtype == torch.float64
