"""Host ms per training step of the detector cell: all of the window's chunks'
seconds (each ending in its losses' copy to the host) over their steps.
Reported beside the trace, from the traced run's own window."""


def read(run):
    if run["trace"] is None:
        return None
    return run["step_ms"]
