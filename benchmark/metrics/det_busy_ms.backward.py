"""Device ms per training step of the operations launched from the detector
step's ``det.backward`` span (the gradients' reset and the backward pass;
autograd's device thread launches inside it), from the profiled steps
(``runs/detector.py::stage_split``)."""


def read(run):
    if run["trace"] is None or run["stages"] is None:
        return None
    return run["stages"]["busy_ms"].get("det.backward", 0.0)
