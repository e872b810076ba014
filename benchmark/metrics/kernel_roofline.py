"""Per cent: the least time of the step's field work (frozen counts at the
cell's shapes, tensor cores or HBM, whichever binds) over the port's kernels'
device time per step, over the recipe's phase mix."""

from benchmark import counts


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    busy = {phase: trace[phase]["own_ms"] for phase in ("warmup", "residual")}
    if min(busy.values()) <= 0.0:
        return None
    return counts.kernel_roofline(run["config"], run["frames"], busy)
