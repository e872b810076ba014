"""Device ms per training step of the operations launched from the detector
step's ``det.optim`` span (the gradients' clipping and the AdamW update),
from the profiled steps (``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.optim", 0.0)
