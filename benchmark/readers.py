"""The per-layer metrics' readers, found by name: ``metrics/<name>.py``
defines ``read(run)``, which returns the metric's value or ``None`` where
the run holds nothing to read it from."""

import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
