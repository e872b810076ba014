"""``graph_step_share`` (``graph_step_share.py``) in the host-bound cells, where
``busy_frame_s`` stands end to end in place of ``frame_s``."""

from benchmark.readers import reader

read = reader("graph_step_share")
