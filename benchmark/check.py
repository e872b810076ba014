"""The numbers that decide ``correct``: the first steps of each phase, as the
program took them, against the plain reference's.

Per phase (warmup from step 0, residual from step 1000), from the same
initial parameters, draws and scenes:

* ``loss_first``: the widest relative gap of the first step's loss over the
  frames;
* ``loss``: the widest relative gap of a step's loss over the three steps
  and the frames;
* ``grad``: the first gradient as the program's optimizer got it (its first
  moment after one step over 1 - beta1), by the median leaf: per leaf the
  gap between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger; the median
  over the leaves of every frame and of every probe (the same first step
  from the initial draw at further step indices, so with other draws);
* ``change``: the same median of each leaf's change after the three steps,
  over the leaves whose first reference gradient is at least a thousandth
  of the median leaf's (a leaf with none moves under Adam by round-off
  alone);
* ``field`` (residual phase): the field kernel's outputs in the first step
  at its own points (``tap.py``) against the reference's at those points:
  for each of ``u``, ``w`` and ``g`` the summed absolute gap over the summed
  absolute residual part of the reference's (its value less the boxes'
  alone), the widest over the outputs and the frames. The aggregates above
  average each point's rounding away; this sees the precision of the
  residual MLP's products;
* ``cotangent`` (residual phase): the weights' cotangent that the backward
  kernel returned, against the reference's for the same output cotangents,
  by the median instance: per instance of a frame the norm of the gap over
  the reference's norm of that instance's row or of the median row,
  whichever is larger; the median over the instances of every frame (a
  row is a sum over all points with heavy cancellation, so its relative
  gap swings with the instance).

A leaf is one tensor of one frame; medians are over the leaves with a
nonzero reference gradient. Each number is the larger of its two phases'.
``phase_readings`` also gives the worst leaf's gaps, which the limits were
read beside (the worst leaf swings with a single sample whose rounding
crosses a facet of a box's distance field).
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_first", "loss", "grad", "change", "field", "cotangent")
FIELD_OUTPUTS = ("u", "w", "g")
DEAD_LEAF = 1e-3


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def leaf_gap(program, reference, median):
    denominator = max(reference, median)
    if denominator == 0.0:
        return 0.0 if program == 0.0 else math.inf
    return abs(program - reference) / denominator


def _gaps(program_norms, reference_norms, median):
    return [leaf_gap(p, r, median) for p, r in zip(program_norms, reference_norms)]


def _ratio(gap, scale) -> float:
    gap, scale = float(gap), float(scale)
    if scale == 0.0:
        return 0.0 if gap == 0.0 else math.inf
    return gap / scale


def field_readings(program, reference) -> dict:
    """``field`` and ``cotangent`` of the per-frame field outputs
    ``program`` (the program's record, or the control's) against the
    reference's (with the boxes' alone under ``box``); infinite where the
    program's record is missing."""
    if not program or not reference:
        return {"field": math.inf, "cotangent": math.inf}
    field = cotangent_sum = 0.0
    rows = []
    for prog, ref in zip(program, reference, strict=True):
        device = ref["u"].device
        for k in FIELD_OUTPUTS:
            gap = torch.sum(torch.abs(prog[k].to(device) - ref[k]))
            field = max(field, _ratio(gap, torch.sum(torch.abs(ref[k] - ref["box"][k]))))
        dweights = prog["dweights"].to(device)
        gap = torch.sum(torch.abs(dweights - ref["dweights"]))
        cotangent_sum = max(cotangent_sum, _ratio(gap, torch.sum(torch.abs(ref["dweights"]))))
        norms = _norms(ref["dweights"])
        alive = [n for n in norms if n > 0.0]
        median = statistics.median(alive or [0.0])
        rows += [leaf_gap_of_rows(a, b, n, median)
                 for a, b, n in zip(dweights, ref["dweights"], norms) if n > 0.0]
    return {"field": field, "cotangent": statistics.median(rows or [math.inf]),
            "cotangent_worst": max(rows, default=math.inf), "cotangent_sum": cotangent_sum}


def leaf_gap_of_rows(program, reference, norm, median):
    """The norm of a row's gap over its reference norm or the median row's."""
    return _ratio(torch.linalg.vector_norm((program - reference).double()), max(norm, median))


def phase_readings(program: dict, reference: dict) -> dict:
    """Every candidate number of one phase: the widest and the median
    leaf's gap of the first gradient and of the change, the widest loss gap
    and that of the first step alone. ``program``/``reference``: ``losses``
    [steps][frames], ``first_grads`` and ``params`` (after the steps) per
    frame as lists of leaves, and ``initial`` the parameters before the
    first step, per frame."""
    rel = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ps, rs)]
           for ps, rs in zip(program["losses"], reference["losses"])]
    grad_gaps = []
    sides = [(program, reference)] + list(zip(program.get("probes", []),
                                              reference.get("probes", [])))
    for index, (prog, ref) in enumerate(sides):
        grad_p = [n for frame in prog["first_grads"] for n in _norms(frame)]
        grad_r = [n for frame in ref["first_grads"] for n in _norms(frame)]
        alive = [r > 0.0 for r in grad_r]
        grad_median = statistics.median([r for r, a in zip(grad_r, alive) if a] or [0.0])
        grad_gaps += [g for g, a in zip(_gaps(grad_p, grad_r, grad_median), alive) if a]
        if index == 0:
            first_r, first_median = grad_r, grad_median

    def changes(side):
        return [n for frame, start in zip(side["params"], program["initial"])
                for n in _norms([a - b for a, b in zip(frame, start)])]

    moving = [r >= DEAD_LEAF * first_median and r > 0.0 for r in first_r]
    change_p = [c for c, keep in zip(changes(program), moving) if keep]
    change_r = [c for c, keep in zip(changes(reference), moving) if keep]
    change_median = statistics.median(change_r or [0.0])
    change_gaps = _gaps(change_p, change_r, change_median)
    readings = {
        "loss": max(max(row) for row in rel),
        "loss_first": max(rel[0]),
        "grad_worst": max(grad_gaps, default=0.0),
        "grad": statistics.median(grad_gaps or [0.0]),
        "change_worst": max(change_gaps, default=0.0),
        "change": statistics.median(change_gaps or [0.0]),
    }
    if "field" in program:
        readings.update(field_readings(program["field"], reference.get("field")))
    return readings


def phase_numbers(program: dict, reference: dict) -> dict:
    """The compared numbers of one phase (``field`` and ``cotangent`` only
    where the residual field is on)."""
    readings = phase_readings(program, reference)
    return {name: readings[name] for name in NUMBERS if name in readings}


def numbers(phases: dict) -> dict:
    """The largest of each number over the phases that have it
    (``{phase: numbers}``)."""
    return {name: max(p[name] for p in phases.values() if name in p) for name in NUMBERS}


def compared(limits: dict) -> list:
    """The numbers a cell compares: those with a limit (a number with no
    upper reading has ``null``)."""
    return [k for k in NUMBERS if limits.get(k) is not None]


def judge(values: dict, limits: dict) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in compared(limits))
