"""Device idle ms per step while the host is in the step's ``vsrd.report`` span:
the span's share of the traced idle gaps times the idle ms per step that
``idle_share`` uses, over the recipe's phase mix (``stages.py``)."""

from benchmark import stages


def read(run):
    return stages.idle_ms(run, "vsrd.report")
