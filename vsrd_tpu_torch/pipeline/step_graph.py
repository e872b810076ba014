"""CUDA graphs over the optimization step.

On a card, ``optimize.optimize_chunk`` replays its steps from CUDA graphs of
the step's own code: one graph launch in place of the 1,100-1,200 kernel
launches a step makes, whose dispatch by the host otherwise sets the pace
of a one-frame step. A graph is kept per key: what the step's code can
observe, that is the phase (``use_rdf``), the parameters' shapes and
dtypes, the configuration and the skip mask's tile, together with the
frame whose tensors it reads (``StepGraphs.entry``). The first step of a key runs eagerly on the
capture stream, which warms the key up (the library, cuBLAS's workspace,
the device constants); the second is captured there and replayed, and
every later step of the key replays. A new frame for a key replaces its
graph and frees it, and a frame's death frees its graphs: no graph
outlives its frame.

What the capture needs of the step: no wait on the device and no tensor
made from a host number inside it. The per-step numbers (the step index
that the annealing reads, Adam's count-dependent scalars) come in as one
device vector that the host fills before each replay; the random draws
come from one CUDA generator whose state the graph tracks
(``register_generator_state``), re-seeded before each replay with the step's seed, so that they are the draws of
``optimize.step_generator``. The parameters and the Adam moments live in
the graph's own buffers while a run of its replays lasts: ``load`` copies
the caller's in, ``store`` copies them back out.

Counters, in the convention of the kernels' launch counters:
``graphs.captures``, ``graphs.replays`` and ``graphs.eager_steps``
(``optimize.train_step``'s calls). A replay advances the field kernels' and
the JV kernel's launch counters by what its graph holds, so that they count
each replayed step's launches as an eager step counts them.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from ..ops import matching
from ..rendering import field_kernels

_FIELD_COUNTERS = ("launches", "batched_launches", "rdf_launches", "skip_launches",
                   "bf16_launches")


def _launch_counters() -> list:
    """The launch counters a step can advance, as (object, attribute)."""
    launchers = (field_kernels.field_forward, field_kernels.field_backward,
                 field_kernels.field_dir_forward, field_kernels.sphere_trace)
    return ([(fn, name) for fn in launchers for name in _FIELD_COUNTERS]
            + [(field_kernels.sphere_trace, "soft_launches"), (matching.jv_assignment, "launches")])


_streams: dict = {}
_generators: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that warms up and captures every graph on ``device``."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


@contextlib.contextmanager
def on_capture_stream(device: torch.device):
    """Work ordered after the current stream's, on the capture stream, and
    the current stream ordered after it."""
    stream, current = capture_stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _generator(graph: torch.cuda.CUDAGraph, device: torch.device) -> torch.Generator:
    """The CUDA generator whose state ``graph`` tracks."""
    if device not in _generators:
        _generators[device] = torch.Generator(device=device)
    graph.register_generator_state(_generators[device])
    return _generators[device]


class StepGraph:
    """One key's step on one frame: eager until it is warm, then captured
    once and replayed."""

    def __init__(self, frame):
        self.frame = weakref.ref(frame)
        self.warm = False
        self.graph = None

    def capture(self, fn, leaves: list, scalars: torch.Tensor, device: torch.device):
        """Capture ``fn(scalars, generator) -> outputs`` (a tuple of
        tensors), which updates ``leaves`` (the graph's own parameters and
        moments) in place and reads the step's numbers from ``scalars``."""
        graph = torch.cuda.CUDAGraph()
        self.leaves, self.scalars = leaves, scalars.clone()
        self.generator = _generator(graph, device)
        counters = _launch_counters()
        before = [getattr(obj, name) for obj, name in counters]
        with torch.cuda.graph(graph, stream=capture_stream(device)):
            self.outputs = fn(self.scalars, self.generator)
        # the capture ran the launchers' code but no kernel: each replay counts
        self.counts = []
        for (obj, name), value in zip(counters, before):
            if getattr(obj, name) != value:
                self.counts.append((obj, name, getattr(obj, name) - value))
            setattr(obj, name, value)
        self.graph = graph
        graphs.captures += 1

    def load(self, leaves: list):
        torch._foreach_copy_(self.leaves, leaves)

    def store(self, leaves: list):
        torch._foreach_copy_(leaves, self.leaves)

    def replay(self, scalars: torch.Tensor, seed: int):
        """One step: the step's numbers in, the generator at ``seed``, the
        graph, and the launch counters advanced by what it holds."""
        self.scalars.copy_(scalars)
        self.generator.manual_seed(seed)
        self.graph.replay()
        for obj, name, count in self.counts:
            setattr(obj, name, getattr(obj, name) + count)
        graphs.replays += 1

    def release(self):
        """Free the graph, its memory pool and its buffers."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.leaves = self.scalars = self.outputs = None


class StepGraphs:
    """The graphs of the process, one per key, and the counters."""

    def __init__(self):
        self._entries: dict = {}
        self.reset_counts()

    def reset_counts(self):
        self.captures = self.replays = self.eager_steps = 0

    def entry(self, key, frame) -> StepGraph:
        """The key's entry for ``frame``: a new one (its first step eager)
        where the key has none or has one for another frame, which it
        replaces and frees."""
        entry = self._entries.get(key)
        if entry is None or entry.frame() is not frame:
            if entry is not None:
                entry.release()
            entry = self._entries[key] = StepGraph(frame)
            weakref.finalize(frame, self._frame_gone, key, entry)
        return entry

    def _frame_gone(self, key, entry: StepGraph):
        if self._entries.get(key) is entry:
            del self._entries[key]
        entry.release()


graphs = StepGraphs()
