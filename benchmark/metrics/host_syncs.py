"""Host calls per step that wait on the device (``stages.SYNC_CALLS``:
stream, device and event synchronizations, blocking copies) in the traced
steps, over the recipe's phase mix (``stages.py``)."""

from benchmark import stages


def read(run):
    return stages.host_syncs(run)
