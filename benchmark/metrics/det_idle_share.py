"""Per cent of the detector step's wall time in which the device runs
nothing: one less the profiled steps' busy time per step (the union of every
device operation, from the trace) over the window's host ms per step (the
host clock of the unprofiled chunks)."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return 100.0 * (1.0 - 1e3 * trace["busy_s"] / trace["steps"] / run["step_ms"])
