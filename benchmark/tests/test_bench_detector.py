"""The ``detector`` run module (``runs/detector.py``) and the cell
``detr-r50-b8`` rehearsed on the CPU at a cut size (64x96 images, batch 2,
10 queries, 2 + 2 layers; the ResNet-50 at its widths), its result line, its
verdict on the bf16 control and on planted faults, its stage spans, its
readers and its counts."""

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import detr_counts, run  # noqa: E402
from benchmark.readers import reader  # noqa: E402

WORKLOAD = "detr-r50-b8"
SEED = 2**31 + 303
SIZES = {"image_size": [64, 96], "batch": 2, "max_boxes": 4, "num_queries": 10,
         "num_encoder_layers": 2, "num_decoder_layers": 2,
         "traffic": {"boxes": [1, 4], "batch_pool": 2, "chunk_steps": 2, "profile_steps": 2}}
detector = run.run_module("detector")


@pytest.fixture(scope="module")
def sound():
    return run.run_cell(WORKLOAD, SEED, 0.2, trace=False, device="cpu", sizes=SIZES)


def test_rehearsal_prints_a_result(sound):
    result, chunks = sound
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(result)
    assert list(result)[-1] == "checks"
    spec = run.load_spec(WORKLOAD)
    assert {m["name"] for m in spec["end_to_end"]} == {"busy_frame_s", "setup_s"}
    assert run.profiled_window(spec)
    # busy_frame_s comes from the card's trace: on the CPU, setup_s alone
    assert set(result["metrics"]) == {"setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert set(result["checks"]) == set(detector.NUMBERS)
    assert result["checks"]["match"]["value"] == 0.0
    assert result["checks"]["cost"]["value"] < 1e-6
    assert all(v["value"] < 1e-2 for v in result["checks"].values())
    assert chunks["step"]
    json.dumps(result)


def test_traced_rehearsal_reads_no_device_metric():
    result, _ = run.run_cell(WORKLOAD, SEED, 0.2, trace=True, device="cpu", sizes=SIZES)
    assert result["metrics"] == {}
    assert "busy_s" not in result["device"]


def verdict(cell, program=None, followed=None):
    followed = followed or detector.follow_reference(cell)
    values = detector.numbers(cell, followed, program)
    limits = cell.spec["limits"]
    return all(values[k] <= limits[k] for k in detector.NUMBERS if limits.get(k) is not None), \
        values


def test_control_and_faults_come_out_not_correct():
    cell = detector.prepare(WORKLOAD, SEED, "cpu", SIZES)
    detector.free_program(cell)
    followed = detector.follow_reference(cell)
    sound = detector.numbers(cell, followed)
    # the control: the reference under bfloat16 autocast in the program's place
    lower = detector.follow_reference(cell, torch.bfloat16)
    judged, values = verdict(cell, {**lower, "initial": cell.record["initial"]}, followed)
    assert not judged
    assert values["output"] > 10 * sound["output"] and values["grad"] > 10 * sound["grad"]
    # what each fault moves, by far
    moved = {"half_batch": "grad_outputs", "unchanged_state": "change",
             "identity_match": "match", "giou_off_cost": "cost"}
    assert set(moved) == set(detector.FAULTS)
    for fault, number in moved.items():
        with detector.FAULTS[fault]():
            faulty = detector.prepare(WORKLOAD, SEED, "cpu", SIZES)
        detector.free_program(faulty)
        # as a run does: the reference follows the faulty run's own record
        judged, values = verdict(faulty)
        assert not judged, (fault, values)
        assert values[number] > 1e4 * max(sound[number], 1e-9), (fault, number, values)


def test_the_recipe_is_held_to_the_configuration(monkeypatch):
    spec = run.load_spec(WORKLOAD)
    config = json.loads(json.dumps(spec["config"]))
    config["optimizer"]["clip_max_norm"] = 1.0
    monkeypatch.setattr(run, "load_spec", lambda *a, **k: {**spec, "config": config})
    with pytest.raises(run.RunError, match="recipe"):
        detector.prepare(WORKLOAD, SEED, "cpu", SIZES)


def test_stage_names_are_the_ports():
    from vsrd_tpu_torch.utils import spans
    assert detector.STAGES == spans.DETECTOR_STAGES
    assert detector.STEP == spans.DETECTOR_STEP


def test_every_operation_of_the_step_falls_in_one_stage():
    """Every operator the step runs on the CPU, the backward's too, lies
    inside one of the stage spans (the same spans split the card's trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cell = detector.prepare(WORKLOAD, SEED, "cpu", SIZES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.step(cell.batches[0])
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    stages = [e.time_range for e in events if e.name in detector.STAGES]
    steps = [e.time_range for e in events if e.name == detector.STEP]
    assert len(steps) == 1 and len(stages) >= 6
    names = {e.name for e in events if e.name in detector.STAGES}
    assert names == set(detector.STAGES)
    ops = [e for e in events if e.name.startswith("aten::")
           and steps[0].start <= e.time_range.start <= steps[0].end]
    assert ops
    outside = [e.name for e in ops
               if not any(s.start <= e.time_range.start <= s.end for s in stages)]
    assert outside == []
    # the split by stage reads the same trace (no device, so no busy, idle or wait)
    split = detector.stage_split(prof, 1)
    assert split == {"busy_ms": {}, "launches": {}, "idle_ms": {}, "syncs": {}}


def test_the_reference_imports_nothing_of_the_port():
    for name in ("detr_reference.py", "detr_counts.py"):
        tree = ast.parse((ROOT / "benchmark" / name).read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "vsrd_tpu", "vsrd_tpu_torch"}, name


def test_counts_of_the_trunk_and_the_step():
    # torchvision's ResNet-50 at 224x224: 4.09 GMAC
    trunk = detr_counts.backbone_macs(224, 224)
    assert (trunk["frozen"] + trunk["trained"] + trunk["weight_only"]) / 1e9 == pytest.approx(
        4.087, abs=0.01)
    config = run.load_spec(WORKLOAD)["config"]
    assert detr_counts.backbone_macs(*config["image_size"])["c5"] == (12, 44)
    assert 2.0e12 < detr_counts.step_flops(config) < 2.3e12
    assert detr_counts.jv_bytes(config) == 48 * (100 * 100 * 4 + 100 * 8)


STAGE_NAMES = ("backbone", "transformer", "match", "loss", "backward", "optim")


def context(trace=True):
    summary = {"steps": 5, "busy_s": 0.4, "kernels": 3000.0,
               "device_ops_s": {"jv_assignment_kernel": 0.005}}
    return {"trace": summary if trace else None,
            "stages": {"busy_ms": {f"det.{s}": 10.0 + i for i, s in enumerate(STAGE_NAMES)},
                       "launches": {},
                       # trace idle ms by stage: 1 + i, and 4 outside every stage (sum 25)
                       "idle_ms": {**{f"det.{s}": 1.0 + i for i, s in enumerate(STAGE_NAMES)},
                                   None: 4.0},
                       "syncs": {"det.loss": 1.0, None: 1.0}},
            "step_ms": 100.0, "flops": 2.0e12, "jv_bytes": 1.0e6}


@pytest.mark.parametrize("name,expected", [
    ("det_step_ms", 100.0), ("det_launches", 3000.0), ("det_idle_share", 20.0),
    ("det_busy_ms.backbone", 10.0), ("det_busy_ms.transformer", 11.0),
    ("det_busy_ms.match", 12.0), ("det_busy_ms.loss", 13.0), ("det_busy_ms.backward", 14.0),
    ("det_busy_ms.optim", 15.0),
    ("det_step_mfu", 100.0 * 2.0e12 / (0.1 * 495e12)),
    ("jv_roofline", 100.0 * 1.0e6 / 3.35e12 / 0.001),
    # the window's idle, 100 - 80 ms a step, split as the trace's idle
    *((f"det_idle_ms.{s}", 20.0 * (1.0 + i) / 25.0) for i, s in enumerate(STAGE_NAMES)),
    ("det_host_syncs", 1.0)])
def test_detector_readers(name, expected):
    assert reader(name)(context()) == pytest.approx(expected)
    assert reader(name)(context(trace=False)) is None
