"""Host ms per residual step: all of the window's residual chunks' time over
their steps, from the traced run's own window."""


def read(run):
    if run["trace"] is None:
        return None
    return run["step_ms"]["residual"]
