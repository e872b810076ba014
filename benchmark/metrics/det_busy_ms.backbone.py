"""Device ms per training step of the operations launched from the detector
step's ``det.backbone`` span (the images' normalization, the ResNet-50, the
input projection and the positions), from the profiled steps
(``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.backbone", 0.0)
