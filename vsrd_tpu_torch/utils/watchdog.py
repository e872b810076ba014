"""Fail-fast guards for entry points that touch the card.

Counterpart of ``vsrd_tpu/utils/watchdog.py``. A phase that hangs inside
native code (a rendezvous whose peers never arrive, a driver call that
never returns) ignores ``KeyboardInterrupt`` and cannot be joined, and
would eat a caller's whole time budget. These helpers bound such phases:
if one does not finish in time the process prints one JSON line on
stdout and exits with code 124, so the caller records a diagnosis in
seconds instead of timing out.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time


@contextlib.contextmanager
def deadline(seconds, phase, on_timeout=None):
    """Hard-exit the process if the body does not finish within ``seconds``.

    A daemon thread fires after the timeout, prints a one-line JSON
    diagnosis (or calls ``on_timeout``) and ``os._exit``\\ s with 124: the
    only reliable escape from a hang in native code.
    """
    done = threading.Event()

    def _fire():
        if done.wait(seconds):
            return
        if on_timeout is not None:
            try:
                on_timeout()
            except Exception:  # the exit below must happen whatever the hook does
                pass
        else:
            print(json.dumps({"error": f"{phase} did not complete within {seconds}s",
                              "phase": phase, "timeout_s": seconds}), flush=True)
        os._exit(124)

    thread = threading.Thread(target=_fire, daemon=True, name=f"deadline:{phase}")
    thread.start()
    try:
        yield
    finally:
        done.set()


def require_backend(timeout_s=90):
    """Bring up CUDA with a deadline; raise on a failure or a hang.

    Probes the device count and a small allocation on every card in a
    worker thread, so that a hung driver cannot block the caller: on a
    timeout the calling thread raises ``RuntimeError`` (the daemon worker
    is abandoned). There is no fallback to the CPU. Returns the cards as
    ``torch.device``\\ s.
    """
    import torch

    result = {}

    def _probe():
        try:
            if not torch.cuda.is_available():
                raise RuntimeError("torch.cuda.is_available() is False")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            for device in devices:
                torch.ones(1, device=device).add_(1).cpu()
            result["devices"] = devices
        except Exception as exc:  # handed to the caller below
            result["error"] = exc

    thread = threading.Thread(target=_probe, daemon=True, name="backend-probe")
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        raise RuntimeError(f"CUDA init did not complete within {timeout_s}s (hung driver?)")
    if "error" in result:
        raise RuntimeError(f"CUDA init failed: {result['error']!r}")
    return result["devices"]


class Heartbeat:
    """Print a periodic one-line progress note, so that a long build or
    step is told apart from a hang in a log's tail."""

    def __init__(self, phase, interval_s=30.0, stream=None):
        self.phase = phase
        self.interval_s = interval_s
        self.stream = stream or sys.stdout
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        self._thread = None

    def __enter__(self):
        def _beat():
            while not self._stop.wait(self.interval_s):
                elapsed = time.monotonic() - self._t0
                print(f"[heartbeat] {self.phase}: still running ({elapsed:.0f}s)",
                      file=self.stream, flush=True)

        self._thread = threading.Thread(target=_beat, daemon=True,
                                        name=f"heartbeat:{self.phase}")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        return False
