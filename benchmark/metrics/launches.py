"""Device kernels per step in the profiled chunks (copies and sets left
out), over the recipe's phase mix."""

from benchmark.counts import mix


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return mix(trace["warmup"]["kernels"], trace["residual"]["kernels"])
