"""Host ms per warmup step: all of the window's warmup chunks' time (each
ending in the chunk's copy of its scalars to the host) over their steps.
Reported beside the trace, from the traced run's own window."""


def read(run):
    if run["trace"] is None:
        return None
    return run["step_ms"]["warmup"]
