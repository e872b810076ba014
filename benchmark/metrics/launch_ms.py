"""Host ms per step inside kernel-launch calls (cudaLaunchKernel and its
driver forms) in the profiled chunks, over the recipe's phase mix."""

from benchmark.counts import mix


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    return mix(trace["warmup"]["launch_ms"], trace["residual"]["launch_ms"])
