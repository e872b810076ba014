"""Host seconds per auto-labeled frame at the full recipe, from the traced
run's own window (which the profiler does not slow): ``frame_s`` as the
other cells hold it end to end, reported per layer in the cells where the
host clock spreads too widely to bound it."""


def read(run):
    if run["trace"] is None:
        return None
    return run["frame_s"]
