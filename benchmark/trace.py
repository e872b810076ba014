"""What a ``torch.profiler`` trace of a chunk of steps says about the device.

Kernels are sorted by origin, not by a list of names: a kernel is the
port's own when its name is declared ``__global__`` in the port's CUDA
sources (``<package>/csrc/*.cu*``) or is a ``@triton.jit`` function of the
package; every other device operation (PyTorch's kernels, cuBLAS, copies and
sets) is the rest of the step. Record-function ranges that the profiler
reports on the device are not operations.
"""

from __future__ import annotations

import collections
import heapq
import re
from pathlib import Path

from torch.autograd import DeviceType

GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10


def own_kernels(package_dir: Path) -> frozenset:
    """Names of the kernels that the package's own sources define."""
    names = set()
    for path in sorted((package_dir / "csrc").glob("*.cu*")):
        names.update(GLOBAL.findall(path.read_text()))
    for path in sorted(package_dir.rglob("*.py")):
        text = path.read_text()
        if "triton.jit" in text:
            names.update(TRITON.findall(text))
    return frozenset(names)


def short_name(key: str) -> str:
    """``void ns::name<args>(params)`` -> ``name``."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    for mark in ("<", "("):
        name = name.split(mark)[0]
    return name.split("::")[-1].strip()


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_busy_s(prof) -> float:
    """Seconds in which the device ran an operation in a profiled span: the
    union of its operations, from the profiler's raw events (a window's
    chunk has too many to parse into ``prof.events()`` in passing)."""
    spans = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    return sum(end - start for start, end in merge(spans)) / 1e9


def summarize(prof, steps: int, own: frozenset, wall_s: float) -> dict:
    """One profiled chunk of ``steps`` steps: per step the device ms of the
    port's kernels and of the rest, the device kernels, the host ms in
    launch calls; the union of device busy time; the device time by
    operation and the device's idle gaps by what the host was running."""
    device, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
    own_us = other_us = 0.0
    kernels = 0
    by_op = collections.Counter()
    for start, end, name in device:
        short = short_name(name)
        by_op[short] += end - start
        if short in own:
            own_us += end - start
        else:
            other_us += end - start
        if not is_copy(name):
            kernels += 1
    busy = merge((s, e) for s, e, _ in device)
    launch_us = sum(e - s for s, e, name in host if name in LAUNCH_CALLS)
    return {
        "steps": steps,
        "wall_s": wall_s,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "own_ms": own_us / 1e3 / steps,
        "other_ms": other_us / 1e3 / steps,
        "kernels": kernels / steps,
        "launch_ms": launch_us / 1e3 / steps,
        "device_ops_s": {k: v / 1e6 for k, v in by_op.items()},
        "idle_gaps_s": idle_gaps(busy, host),
    }


def idle_gaps(busy, host) -> dict:
    """Seconds of the gaps between device work, by the innermost host
    operation (the latest to start, on any thread) running at each gap's
    middle."""
    gaps = collections.Counter()
    spans = [((end + start) / 2, (start - end) / 1e6)
             for (_, end), (start, _) in zip(busy, busy[1:])]
    host = sorted(host)
    live, i = [], 0
    for middle, seconds in sorted(spans):
        while i < len(host) and host[i][0] <= middle:
            heapq.heappush(live, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while live and live[0][1] < middle:
            heapq.heappop(live)
        gaps[live[0][2] if live else "(between host operations)"] += seconds
    return dict(gaps)


def breakdown(summaries) -> dict:
    """The traced chunks' longest device operations and idle gaps."""
    ops, gaps = collections.Counter(), collections.Counter()
    for s in summaries:
        ops.update(s["device_ops_s"])
        gaps.update(s["idle_gaps_s"])
    return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}
