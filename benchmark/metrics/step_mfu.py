"""Per cent of the card's bf16 tensor-core peak that the step's counted field
work fills in the step's wall time (the window's host ms per step), over the
recipe's phase mix."""

from benchmark import counts


def read(run):
    if run["trace"] is None:
        return None
    return counts.step_mfu(run["config"], run["frames"], run["step_ms"])
