"""A cut-size rehearsal of a cell's run on the CPU, where the port runs its
kernels' plain twins: the result line's keys, the files the harness finds
by name, the field kernels' outputs that the check reads, and the
comparison's verdict on the float8 control and on planted faults."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, control, reference, run  # noqa: E402
from vsrd_tpu_torch.pipeline import optimize as opt  # noqa: E402

# a cell cut to a size that a test run holds: 2 views of 24x32, 3 cars, 16 rays
SIZES = {"views": 2, "image_size": [24, 32], "instances": 3, "max_instances": 3, "candidates": 256,
         "optimization": {"num_rays": 16, "num_samples": 8}}
SEED = 2**31 + 77


def test_every_named_file_is_there():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
    for cell in bench["workloads"]:
        spec = run.load_spec(cell["name"])
        own_run = spec["config"].get("run")
        if own_run is None:
            assert spec["traffic"]["frames"] >= 1
            assert set(check.NUMBERS) <= set(spec["limits"])
        else:
            # a cell of another kind: the files and limits its run module declares
            module = run.run_module(own_run)
            for path in module.named_files(spec):
                assert path.is_file(), path
            assert set(module.NUMBERS) <= set(spec["limits"])
    for metric in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
        # every cell that reads the metric reports the end-to-end metric it moves
        for cell in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in run.load_spec(cell)["end_to_end"]}


@pytest.mark.parametrize("workload", ["b8-f1", "b8-f8"])
def test_rehearsal_prints_a_result(workload):
    result, chunks = run.run_cell(workload, SEED, 0.2, trace=False, device="cpu", sizes=SIZES)
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(result)
    assert list(result)[-1] == "checks"
    # the cell's end-to-end metrics but those read from the card's trace
    expected = {m["name"] for m in run.load_spec(workload)["end_to_end"]
                if m["source"] != "device_trace"}
    assert set(result["metrics"]) == expected and "setup_s" in expected
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert all(chunks[phase] for phase in run.PHASES)
    json.dumps(result)


def test_traced_rehearsal_reads_no_device_metric():
    result, _ = run.run_cell("b8-f1", SEED, 0.2, trace=True, device="cpu", sizes=SIZES)
    # the per-layer metrics come from the card's trace: none without one
    assert result["metrics"] == {}
    assert "busy_s" not in result["device"]


def test_device_busy_is_the_union_of_device_operations():
    from torch.autograd import DeviceType
    from benchmark import trace

    class Event:
        def __init__(self, device, start, end, annotation=False):
            self.device, self.start, self.end, self.annotation = device, start, end, annotation

        def device_type(self):
            return self.device

        def start_ns(self):
            return self.start

        def end_ns(self):
            return self.end

        def is_user_annotation(self):
            return self.annotation

    events = [Event(DeviceType.CUDA, 0, 4_000), Event(DeviceType.CUDA, 2_000, 5_000),
              Event(DeviceType.CUDA, 9_000, 10_000), Event(DeviceType.CPU, 0, 50_000),
              Event(DeviceType.CUDA, 0, 90_000, annotation=True)]
    prof = type("Prof", (), {})()
    prof.profiler = type("Inner", (), {})()
    prof.profiler.kineto_results = type("Results", (), {"events": lambda self: events})()
    assert trace.device_busy_s(prof) == pytest.approx(6e-6)


def test_only_a_device_metric_profiles_the_window():
    assert run.profiled_window(run.load_spec("b8-f1"))
    assert not run.profiled_window(run.load_spec("b8-f8"))


def verdict(records, followed, limits):
    values = check.numbers({name: check.phase_numbers(records[name], followed[name])
                            for name in run.PHASES})
    return check.judge(values, limits), values


@pytest.mark.parametrize("workload", ["b8-f1", "b8-f8"])
def test_the_residual_step_records_its_field_call(workload):
    cell = run.prepare(workload, SEED, "cpu", SIZES)
    frames = cell.frames
    assert "field" not in cell.records["warmup"]        # box only: no products to check
    calls = cell.records["residual"]["field"]
    assert len(calls) == frames
    points = 16 * (2 * 8 - 1)
    for call in calls:
        assert call["positions"].shape == (points, 3)
        assert call["u"].shape == call["du"].shape == (points,)
        assert call["w"].shape == call["dw"].shape == (points, 3)
        assert call["g"].shape == call["dg"].shape == (points, 3)
        assert call["dweights"].shape == (3, 1617)
        assert call["dweights"].abs().sum() > 0
    run.free_program(cell)
    followed = run.follow_reference(cell)
    sound = check.phase_numbers(cell.records["residual"], followed["residual"])
    assert 0.0 < sound["field"] < 0.1 and 0.0 < sound["cotangent"] < 0.1
    # a step that made no such call reads no number, and is not correct
    cell.records["residual"]["field"] = None
    missing = check.phase_numbers(cell.records["residual"], followed["residual"])
    assert missing["field"] == missing["cotangent"] == float("inf")


@pytest.mark.parametrize("workload", ["b8-f1", "b8-f8"])
def test_control_and_faults_come_out_not_correct(workload):
    cell = run.prepare(workload, SEED, "cpu", SIZES)
    run.free_program(cell)
    followed = run.follow_reference(cell)
    limits = cell.spec["limits"]
    # (the limits were read on the card at the cell's size; a sound run at
    # this cut size reads its own, larger gaps, so only the faults are judged)
    sound = verdict(cell.records, followed, limits)[1]
    assert all(v < 1.0 for v in sound.values())
    # the control: the reference in scaled float8 in the program's place; at
    # this size its field reads about 15 times the sound run's
    lower = run.follow_reference(cell, products=reference.lower_precision(torch.float8_e4m3fn))
    judged, values = verdict(lower, followed, limits)
    assert not judged
    for number in ("field", "cotangent"):
        assert values[number] > 5 * sound[number]
    for fault in ("half_batch", "unchanged_state"):
        with control.FAULTS[fault](opt):
            faulty = run.prepare(workload, SEED, "cpu", SIZES)
        run.free_program(faulty)
        # as a run does: the reference follows the faulty run's own records
        assert not verdict(faulty.records, run.follow_reference(faulty), limits)[0], fault
