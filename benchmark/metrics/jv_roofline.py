"""Per cent: the JV kernel's least time (its bytes, ``detr_counts.jv_bytes``,
over the card's HBM bandwidth) over its device time per step in the profiled
steps (one launch a step), the share of its roofline that the matching
kernel reaches."""

from benchmark.detr_counts import PEAK_HBM_BYTES

KERNEL = "jv_assignment_kernel"


def read(run):
    trace = run["trace"]
    if trace is None or not trace["device_ops_s"].get(KERNEL):
        return None
    seconds = trace["device_ops_s"][KERNEL] / trace["steps"]
    return 100.0 * run["jv_bytes"] / PEAK_HBM_BYTES / seconds
