"""Device idle ms per training step in the detector step's ``det.backward``
span (the gradients' reset and the backward pass): the profiled steps' gaps
between the device's busy intervals, each to the stage open at its middle
(``runs/detector.py::stage_split``), as a share of all their gaps times the
window's idle ms per step (its host ms per step less the profiled busy ms
per step, as ``det_idle_share`` has it)."""


def read(run):
    trace, stages = run["trace"], run["stages"]
    if trace is None or stages is None or "idle_ms" not in stages:
        return None
    total = sum(stages["idle_ms"].values())
    window = run["step_ms"] - 1e3 * trace["busy_s"] / trace["steps"]
    return window * stages["idle_ms"].get("det.backward", 0.0) / total if total else 0.0
