"""Per cent of the card's dense TF32 tensor-core peak that the detector step's
model FLOPs (``detr_counts.step_flops``: the convolutions' and matmuls'
products of the forward and the backward at the configuration's shapes)
fill in the step's wall time (the window's host ms per step)."""

from benchmark.detr_counts import PEAK_TF32_FLOPS


def read(run):
    if run["trace"] is None:
        return None
    return 100.0 * run["flops"] / (run["step_ms"] / 1e3 * PEAK_TF32_FLOPS)
