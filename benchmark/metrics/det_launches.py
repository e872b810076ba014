"""Device kernels per training step of the detector cell in the profiled
steps (copies and sets left out)."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return trace["kernels"]
