"""``stages.py``: the device's work and idle time put down to the port's
stage spans, on hand-built profiler events; its frozen stage names against
the port's; its readers on runs with nothing to read."""

import sys
from pathlib import Path

import pytest
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import readers, stages  # noqa: E402

MAIN, WORKER = 1, 2


class Event:
    """What ``stages`` reads of a ``torch.profiler`` FunctionEvent (times in us)."""

    def __init__(self, name, start, end, device=DeviceType.CPU, cid=0, thread=MAIN,
                 annotation=False):
        self.name, self.id, self.thread = name, cid, thread
        self.device_type, self.is_user_annotation = device, annotation
        self.time_range = type("Range", (), {"start": start, "end": end})()


def kernel(name, start, end, cid):
    return Event(name, start, end, DeviceType.CUDA, cid)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def one_step():
    """A step of 100 us: boxes [0, 20], rays [20, 30], render [30, 60],
    backward [60, 85] (autograd's thread launches), adam [85, 95], the
    step's own 5 us, then a launch outside every step; the device runs one
    op per launch."""
    ranges = [("vsrd.boxes", 0, 20), ("vsrd.rays", 20, 30), ("vsrd.render", 30, 60),
              ("vsrd.backward", 60, 85), ("vsrd.adam", 85, 95)]
    events = [Event("vsrd.step", 0, 100, annotation=True)]
    events += [Event(name, a, b, annotation=True) for name, a, b in ranges]
    # the same names on the device's timeline are annotations, not work
    events += [Event("vsrd.render", 31, 70, DeviceType.CUDA, annotation=True)]
    events += [
        Event("cudaLaunchKernel", 2, 3, cid=11), kernel("match_kernel", 4, 8, 11),
        Event("cudaMemcpyAsync", 21, 22, cid=12), kernel("Memcpy HtoD", 22, 23, 12),
        Event("cudaStreamSynchronize", 22, 24),
        # the profiler's own wait when it stops, outside every stage
        Event("cudaDeviceSynchronize", 120, 121),
        Event("cudaLaunchKernel", 32, 33, cid=13), kernel("rev_forward_kernel", 33, 50, 13),
        Event("cudaLaunchKernel", 62, 63, cid=14, thread=WORKER),
        kernel("instance_backward_kernel", 63, 80, 14),
        Event("cudaLaunchKernel", 86, 87, cid=15), kernel("elementwise_kernel", 87, 90, 15),
        # launched outside every step
        Event("cudaLaunchKernel", 101, 102, cid=16), kernel("elementwise_kernel", 110, 111, 16),
    ]
    return events


def test_device_work_goes_to_the_stage_of_its_launch_call():
    found = stages.stages(Prof(one_step()), 1, frozenset({"rev_forward_kernel",
                                                          "instance_backward_kernel"}))
    assert found["launches"] == {"vsrd.boxes": 1, "vsrd.render": 1, "vsrd.backward": 1,
                                 "vsrd.adam": 1, None: 1}
    # the copy counts as device time, not as a launch
    assert found["busy_ms"] == pytest.approx({"vsrd.boxes": 0.004, "vsrd.rays": 0.001,
                                              "vsrd.render": 0.017, "vsrd.backward": 0.017,
                                              "vsrd.adam": 0.003, None: 0.001})
    assert found["own_ms"] == pytest.approx({"vsrd.render": 0.017, "vsrd.backward": 0.017})
    # the launch on autograd's thread goes by time to the backward
    assert found["launches"]["vsrd.backward"] == 1
    assert found["syncs"] == {"vsrd.rays": 1, None: 1}


def test_idle_gaps_go_to_the_stage_open_at_their_middle():
    found = stages.stages(Prof(one_step()), 1, frozenset())
    # busy [4, 8] [22, 23] [33, 50] [63, 80] [87, 90] [110, 111]: the gaps'
    # middles 15, 28, 56.5, 83.5 and 100, the last in the step's own time
    assert found["idle_s"] == pytest.approx({"vsrd.boxes": 14e-6, "vsrd.rays": 10e-6,
                                             "vsrd.render": 13e-6, "vsrd.backward": 7e-6,
                                             "vsrd.step": 20e-6})
    assert found["idle_total_s"] == pytest.approx(64e-6)


def test_per_step_counts_and_no_stage_spans():
    events = one_step()
    assert stages.stages(Prof(events), 2, frozenset())["launches"]["vsrd.adam"] == 0.5
    # a program without the stage spans (the step's span alone is no stage)
    plain = [e for e in events if e.name not in stages.STAGES]
    assert stages.stages(Prof(plain), 1, frozenset()) is None


def test_innermost_takes_the_latest_open_span():
    spans = [(0, 100, "outer"), (10, 20, "inner"), (50, 60, "other")]
    assert stages.innermost(spans, [15, 5, 55, 30, 200, -1]) == [
        "inner", "outer", "other", "outer", None, None]


def run_context(found):
    """A traced run's context, with ``found`` as its stage trace."""
    trace = {p: {"busy_s": 0.004 * 10, "steps": 10, "own_ms": 0.03, "other_ms": 0.015}
             for p in stages.PHASES}
    return {"trace": trace, "step_ms": {"warmup": 10.0, "residual": 16.0}, "stages": found,
            "config": {}, "frames": 1}


def test_idle_ms_splits_the_idle_total_that_idle_share_uses():
    found = {p: stages.stages(Prof(one_step()), 1, frozenset()) for p in stages.PHASES}
    run = run_context(found)
    split = {stage: stages.idle_ms(run, stage) for stage in stages.STAGES}
    # idle_share's total: the unprofiled ms per step less the traced busy ms per step
    total = (1 * (10.0 - 4.0) + 2 * (16.0 - 4.0)) / 3
    outside = total * 20 / 64
    assert sum(split.values()) + outside == pytest.approx(total)
    assert split["vsrd.adam"] == split["vsrd.report"] == 0.0
    assert split["vsrd.rays"] == pytest.approx(total * 10 / 64)
    assert stages.launches(run, "vsrd.render") == 1.0
    assert stages.host_syncs(run) == 1.0


def test_busy_ms_splits_the_runs_own_device_time():
    found = {p: stages.stages(Prof(one_step()), 1, frozenset()) for p in stages.PHASES}
    run = run_context(found)
    split = {stage: stages.busy_ms(run, stage) for stage in stages.STAGES}
    # the trace's 0.043 device ms, 0.001 of them launched outside every step,
    # scaled to the run's own 0.045 ms a step
    assert split["vsrd.backward"] == pytest.approx(0.045 * 0.017 / 0.043)
    assert sum(split.values()) == pytest.approx(0.045 * 0.042 / 0.043)


def test_readers_read_nothing_without_a_stage_trace():
    names = [f"{kind}.{stage.split('.')[1]}" for kind in ("launches", "busy_ms", "idle_ms")
             for stage in stages.STAGES] + ["host_syncs"]
    assert len(names) == 19
    for name in names:
        for metric in (name, f"{name}.host_bound"):
            read = readers.reader(metric)
            assert read({"trace": None}) is None
            assert read(run_context(None)) is None
    found = {p: stages.stages(Prof(one_step()), 1, frozenset()) for p in stages.PHASES}
    assert readers.reader("launches.render.host_bound")(run_context(found)) == 1.0


def test_frozen_stage_names_are_the_ports():
    from vsrd_tpu_torch.utils import spans
    assert stages.STAGES == spans.STAGES
    assert stages.STEP == spans.STEP


def test_a_cut_rehearsal_profiles_every_stage_on_the_cpu(monkeypatch):
    """The readers' own chunks through the port's twins at a cut size: every
    stage span is there (the CPU has no device operations to attribute)."""
    from benchmark import run
    sizes = {"views": 2, "image_size": [24, 32], "instances": 3, "max_instances": 3,
             "candidates": 256}
    config = {**run.load_spec("b8-f1")["config"], **sizes}
    config["optimization"] = {**config["optimization"], "num_rays": 16, "num_samples": 8}
    monkeypatch.setattr(stages, "STEPS", 2)
    found = stages.profile_stages(config, 2, device="cpu")
    for phase in stages.PHASES:
        assert found[phase]["steps"] == 2
        assert found[phase]["launches"] == found[phase]["busy_ms"] == {}
        assert found[phase]["idle_total_s"] == 0


def test_a_program_without_the_spans_is_not_profiled(monkeypatch):
    import importlib.util
    run = run_context(None)
    del run["stages"]
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    monkeypatch.setattr(stages, "profile_stages", lambda *a: pytest.fail("profiled"))
    assert stages.traced(run) is None and run["stages"] is None
