"""Device ms per training step of the operations launched from the detector
step's ``det.transformer`` span (the encoder, the decoder and the heads on
every level), from the profiled steps (``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.transformer", 0.0)
