"""The cell ``b8-f2`` (two frames of the 8-car bucket co-optimized) rehearsed
on the CPU at the frame cells' cut size: its result line (``busy_frame_s``
end to end, as ``b8-f1``: its steps are the host's), its verdict on the
float8 control and the planted faults."""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, control, reference, run  # noqa: E402
from vsrd_tpu_torch.pipeline import optimize as opt  # noqa: E402

SIZES = {"views": 2, "image_size": [24, 32], "instances": 3, "max_instances": 3, "candidates": 256,
         "optimization": {"num_rays": 16, "num_samples": 8}}
SEED = 2**31 + 79
WORKLOAD = "b8-f2"


def test_rehearsal_prints_a_result():
    result, chunks = run.run_cell(WORKLOAD, SEED, 0.2, trace=False, device="cpu", sizes=SIZES)
    assert list(result)[-1] == "checks"
    spec = run.load_spec(WORKLOAD)
    assert {m["name"] for m in spec["end_to_end"]} == {"busy_frame_s", "setup_s"}
    assert run.profiled_window(spec)
    # busy_frame_s comes from the card's trace: on the CPU, setup_s alone
    assert set(result["metrics"]) == {"setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(chunks[phase] for phase in run.PHASES)
    assert set(check.NUMBERS) <= set(run.load_spec(WORKLOAD)["limits"])
    json.dumps(result)


def test_two_frames_with_four_probes():
    cell = run.prepare(WORKLOAD, SEED, "cpu", SIZES)
    assert cell.frames == 2
    assert len(cell.records["residual"]["probes"]) == 3
    assert len(cell.records["residual"]["field"]) == 2


def verdict(records, followed, limits):
    values = check.numbers({name: check.phase_numbers(records[name], followed[name])
                            for name in run.PHASES})
    return check.judge(values, limits), values


def test_control_and_faults_come_out_not_correct():
    cell = run.prepare(WORKLOAD, SEED, "cpu", SIZES)
    run.free_program(cell)
    followed = run.follow_reference(cell)
    limits = cell.spec["limits"]
    lower = run.follow_reference(cell, products=reference.lower_precision(torch.float8_e4m3fn))
    assert not verdict(lower, followed, limits)[0]
    for fault in ("half_batch", "unchanged_state"):
        with control.FAULTS[fault](opt):
            faulty = run.prepare(WORKLOAD, SEED, "cpu", SIZES)
        run.free_program(faulty)
        assert not verdict(faulty.records, run.follow_reference(faulty), limits)[0], fault
