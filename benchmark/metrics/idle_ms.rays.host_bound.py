"""``idle_ms.rays`` (``idle_ms.rays.py``) in the host-bound cells, where ``busy_frame_s``
stands end to end in place of ``frame_s``."""

from benchmark.readers import reader

read = reader("idle_ms.rays")
