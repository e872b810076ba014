"""Device ms per step of the operations launched from the step's ``vsrd.rays``
span, the port's own kernels included: the span's share of the traced device
time times the run's traced device ms per step, over the recipe's phase mix
(``stages.py``)."""

from benchmark import stages


def read(run):
    return stages.busy_ms(run, "vsrd.rays")
