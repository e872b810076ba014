"""Device ms per training step of the operations launched from the detector
step's ``det.loss`` span (the matched losses of every level and their total;
the step's report of them), from the profiled steps
(``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.loss", 0.0)
