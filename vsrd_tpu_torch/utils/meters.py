"""Progress meters and a stopwatch.

Counterpart of ``vsrd_tpu/utils/meters.py`` (the original VSRD's
``ProgressMeter``/``StopWatch``; its ``AverageMeter`` has no caller here).
"""

from __future__ import annotations

import collections
import time


class EMAMeter:
    def __init__(self, momentum=0.9):
        self.momentum = momentum
        self.value = None

    def update(self, value):
        self.value = (
            value
            if self.value is None
            else self.momentum * self.value + (1.0 - self.momentum) * value
        )


class ProgressMeter:
    """Tracks per-phase durations and derives progress / ETA."""

    def __init__(self, total_steps, momentum=0.9):
        self.total_steps = total_steps
        self.meters = collections.defaultdict(lambda: EMAMeter(momentum))
        self.step = 0

    def update(self, count=1, **durations):
        """``count`` = number of total_steps units this update covers
        (e.g. checkpoint_interval * co-optimized frames). Durations are
        normalized to per-unit so ETA stays consistent."""
        for name, duration in durations.items():
            self.meters[name].update(duration / max(count, 1))
        self.step += count

    def keys(self):
        return self.meters.keys()

    def means(self):
        return [m.value for m in self.meters.values()]

    def progress(self):
        return self.step / max(self.total_steps, 1)

    def arrival_seconds(self):
        per_step = sum(m.value or 0.0 for m in self.meters.values())
        return int(per_step * (self.total_steps - self.step))


class StopWatch:
    """start/restart/stop stopwatch."""

    def __init__(self):
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def restart(self):
        now = time.perf_counter()
        elapsed = now - (self._t0 if self._t0 is not None else now)
        self._t0 = now
        return elapsed

    def stop(self):
        elapsed = self.restart()
        self._t0 = None
        return elapsed
