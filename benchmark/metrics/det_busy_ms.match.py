"""Device ms per training step of the operations launched from the detector
step's ``det.match`` span (every level's matching cost and their one JV
launch), from the profiled steps (``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.match", 0.0)
