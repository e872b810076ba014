"""Device kernels per step launched from the step's ``vsrd.backward`` span (copies
and sets left out), over the recipe's phase mix (``stages.py``)."""

from benchmark import stages


def read(run):
    return stages.launches(run, "vsrd.backward")
