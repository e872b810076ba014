"""Device ms per step of the port's own kernels (those its CUDA sources
declare: the field kernels and JV), over the recipe's phase mix."""

from benchmark.counts import mix


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return mix(trace["warmup"]["own_ms"], trace["residual"]["own_ms"])
