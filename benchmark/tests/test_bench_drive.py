"""The run-module route and its worked example, ``runs/drive.py``: a
configuration that names a run module is dispatched to it with no edit to
``run.py``; the ``b16-drive`` cell rehearsed on the CPU at a cut size (2
targets of 3 views at 24x32, 3 cars, 16 rays), its result line, and its
verdict on planted faults in the data and in the optimization; the tree
writer's and the data reference's pieces against the port's."""

import ast
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, control, drive_reference, reference, run, tree  # noqa: E402
from benchmark.readers import reader  # noqa: E402
from vsrd_tpu_torch.data import kitti360, native, rle  # noqa: E402
from vsrd_tpu_torch.pipeline import optimize as opt  # noqa: E402

H, W = 24, 32
SEED = 2**31 + 7
LAYOUT_SEED = 2**31 + 91      # both scenes hold cars that their 24x32 target view keeps


def chain(area, box):
    names = [("Resizer", [[H, W]]), ("MaskAreaFilter", [1]), ("MaskRefiner", []),
             ("MaskAreaFilter", [area]), ("BoxGenerator", []), ("BoxSizeFilter", [box]),
             ("SoftRasterizer", [])]
    return [{"function": f"vsrd.transforms.{name}", "args": args} for name, args in names]


# the cell cut to a size that a test run holds; the target's filters scaled
# down with the image (the shipped 128-pixel masks and 16-pixel boxes would
# leave no car at 24x32)
SIZES = {"traffic": {"targets": 2, "layout_seed": LAYOUT_SEED}, "views": 3,
         "image_size": [H, W], "instances": 3, "max_instances": 8, "candidates": 256,
         "optimization": {"num_rays": 16, "num_samples": 8},
         "filters": {"target_min_mask_area": 4, "target_min_box_size": 2},
         "driver": {"volume_rendering": {"num_rays": 16, "num_fine_samples": 8},
                    "datasets": {"train": {"kwargs": {
                        "num_source_frames": 2, "num_workers": 1,
                        "target_transforms": chain(4, 2), "source_transforms": chain(1, 1)}}}}}


def rehearse(trace=False):
    return run.run_cell("b16-drive", SEED, 0.2, trace=trace, device="cpu", sizes=SIZES)


@pytest.fixture(scope="module")
def sound():
    return rehearse()


def test_a_named_run_module_is_dispatched_to(tmp_path):
    bench = tmp_path / "benchmark"
    for folder in ("configs", "traffic", "checks", "runs"):
        (bench / folder).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "other", "file": "benchmark/configs/other.json"}],
        "workloads": [{"name": "cell", "config": "other", "traffic": "mix", "chips": 1}],
        "end_to_end": [], "per_layer": []}))
    (bench / "configs" / "other.json").write_text(json.dumps({"run": "probe"}))
    (bench / "traffic" / "mix.json").write_text("{}")
    (bench / "checks" / "cell.json").write_text("{}")
    (bench / "runs" / "probe.py").write_text(
        "def run_cell(workload, seed, seconds, trace, device, sizes, root):\n"
        "    return {'ran': (workload, seed, seconds, trace, device, sizes, str(root))}, {}\n")
    result, chunks = run.run_cell("cell", 5, 1.5, True, "cpu", {"k": 1}, root=tmp_path)
    assert result == {"ran": ("cell", 5, 1.5, True, "cpu", {"k": 1}, str(tmp_path))}
    assert chunks == {}


def test_drive_rehearsal_prints_a_result(sound):
    result, chunks = sound
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(result)
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"load_s", "setup_s"}
    assert result["metrics"]["load_s"]["value"] > 0
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    checks = result["checks"]
    assert set(drive_reference.NUMBERS) | {"unfinished", "log_errors"} <= set(checks)
    for name in ("data_layout", "data_boxes", "data_masks", "unfinished", "log_errors"):
        assert checks[name]["value"] == 0.0, name
    assert 0.0 <= checks["drive_loss_first"]["value"] <= checks["drive_loss_first"]["limit"]
    assert len(chunks["wait"]) == len(chunks["frame"]) == 2
    json.dumps(result)


def test_traced_drive_rehearsal_reads_no_device_metric():
    result, _ = rehearse(trace=True)
    assert result["metrics"] == {}
    assert "busy_s" not in result["device"] and result["correct"]


def shifted_first_mask(decode):
    """``rle.decode`` that moves the first mask it decodes by one pixel."""
    calls = []

    def shifted(mask_rle):
        mask = decode(mask_rle)
        calls.append(1)
        return np.roll(mask, 1, axis=1) if len(calls) == 1 else mask
    return shifted


@pytest.mark.parametrize("fault", ["mask_shifted", "half_batch", "unchanged_state"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    if fault == "mask_shifted":
        monkeypatch.setattr(rle, "decode", shifted_first_mask(rle.decode))
        result, _ = rehearse()
        assert result["checks"]["data_masks"]["value"] > 0.0
    else:
        with control.FAULTS[fault](opt):
            result, _ = rehearse()
    if fault == "half_batch":
        # the driver's own first step is held too, not only set-up's
        item = result["checks"]["drive_loss_first"]
        assert item["value"] > item["limit"]
    assert not result["correct"], fault


def test_setup_counts_from_the_harness_process_start(monkeypatch):
    drive = run.run_module("drive")
    assert drive.process_start() == run.START
    monkeypatch.setitem(sys.modules, "__main__", types.SimpleNamespace(START=-5.0))
    assert drive.process_start() == -5.0


def test_a_data_path_without_its_library_is_no_run(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(native, "build_error", "g++: not found")
    with pytest.raises(run.RunError, match="g\\+\\+: not found"):
        rehearse()


def test_the_float8_control_is_not_correct():
    cell = run.prepare("b16-drive", SEED, "cpu", SIZES)
    run.free_program(cell)
    followed = run.follow_reference(cell)
    limits = cell.spec["limits"]
    numbers = lambda records, ref: check.numbers(  # noqa: E731
        {name: check.phase_numbers(records[name], ref[name]) for name in run.PHASES})
    sound = numbers(cell.records, followed)
    lower = run.follow_reference(cell, products=reference.lower_precision(torch.float8_e4m3fn))
    values = numbers(lower, followed)
    assert not check.judge(values, limits)
    for number in ("field", "cotangent"):
        assert values[number] > 5 * sound[number]


def test_compressed_counts_decode_to_the_masks():
    gen = torch.Generator().manual_seed(3)
    masks = torch.rand(5, 17, 23, generator=gen) > 0.6
    masks[0] = False
    masks[1] = True
    masks[2, :, :4] = True
    for mask, counts in zip(masks, tree.rle_counts(masks)):
        encoded = {"size": [17, 23], "counts": tree.compress_counts(counts)}
        assert np.array_equal(rle.decode(encoded), mask.numpy().astype(np.uint8))
        assert encoded["counts"] == rle.compress_counts(rle.encode_counts(mask.numpy()))


def test_header_gives_the_size():
    path = Path(__file__).parent / "__header_probe.png"
    try:
        path.write_bytes(tree.png_header(376, 1408))
        assert kitti360.png_size(str(path)) == (376, 1408)
    finally:
        path.unlink()


@pytest.mark.parametrize("target", range(4))
def test_gravity_rotation_is_the_drivers_rectification(target):
    pose = tree.rig_pose(2**31 + 17, target)
    extrinsic = np.linalg.inv(pose)
    ours = drive_reference.gravity_rotation(extrinsic)
    assert np.allclose(ours, kitti360.rectification_matrix_np(extrinsic.astype(np.float32)),
                       atol=1e-6)
    assert not np.allclose(ours, np.eye(3), atol=1e-4)


def test_the_data_reference_imports_nothing_of_the_port():
    for name in ("drive_reference.py", "tree.py"):
        names = set()
        for node in ast.walk(ast.parse((ROOT / "benchmark" / name).read_text())):
            if isinstance(node, ast.Import):
                names.update(alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "vsrd_tpu", "vsrd_tpu_torch"}, name


@pytest.mark.parametrize("name,expected", [("load_work_s", 26 / 3), ("drive_idle_share", 40.0)])
def test_driver_readers(name, expected):
    drive = {"waits_s": [8.0, 10.0, 2.0], "logged_load_s": [9.0, 7.5, 9.5], "wall_s": 50.0}
    assert reader(name)({"trace": {}, "drive": drive}) == pytest.approx(expected)
    assert reader(name)({"trace": None, "drive": drive}) is None
