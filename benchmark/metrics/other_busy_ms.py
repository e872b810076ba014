"""Device ms per step of every operation that is not one of the port's own
kernels (PyTorch's kernels, cuBLAS, copies and sets): the loss, the renderer
and Adam, over the recipe's phase mix."""

from benchmark.counts import mix


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return mix(trace["warmup"]["other_ms"], trace["residual"]["other_ms"])
