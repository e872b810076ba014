"""``busy_ms.boxes`` (``busy_ms.boxes.py``) in the host-bound cells, where ``busy_frame_s``
stands end to end in place of ``frame_s``."""

from benchmark.readers import reader

read = reader("busy_ms.boxes")
