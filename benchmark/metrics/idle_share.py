"""Per cent of the step's wall time in which the device runs nothing: one
less the profiled chunks' busy time per step (the union of every device
operation, from the trace) over the window's host ms per step (the host
clock of the unprofiled chunks, which the profiler does not slow), over the
recipe's phase mix. Two sources: the trace's busy time, the host's wall."""

from benchmark.counts import mix


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    busy = mix(*(1e3 * trace[p]["busy_s"] / trace[p]["steps"] for p in ("warmup", "residual")))
    wall = mix(run["step_ms"]["warmup"], run["step_ms"]["residual"])
    return 100.0 * (1.0 - busy / wall)
