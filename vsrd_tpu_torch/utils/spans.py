"""Named spans inside the optimization step, for ``torch.profiler``.

A span is a ``record_function`` range while a profiler is active, so that
it lands in the same trace, on the same clock, as the device's kernels and
copies; otherwise ``span`` returns one shared no-op context and costs a
function call and the profiler's own enabled flag. Nothing is exported
here: whoever profiles keeps the spans in the profiler's memory and writes
them out (``scripts/profile.py --trace-dir``).

``train_step`` runs under ``vsrd.step``, and every operation it launches
falls inside exactly one of the stages below; ``optimize_chunk``'s stack
and copy of the scalars to the host run under ``vsrd.report`` too. The
field kernels' wrappers name their calls ``field_kernels.fused_field_with_grad``, ``fused_field_dir_forward``
and ``field_backward``.

The detector's training step (``pipeline/detector_training.py``) runs under
``det.step`` and every operation it launches falls inside exactly one of
``DETECTOR_STAGES``: the model's forward names its two, ``detr_loss`` its
matching and its loss, the step the rest.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

STEP = "vsrd.step"
STAGE_MEANINGS = {
    "vsrd.boxes": "decode and project the boxes, match them to the target view, the "
                  "projection losses",
    "vsrd.rays": "the annealing scalars, the hypernetwork, the skip orders, the ray draw "
                 "and the rays' origins and directions",
    "vsrd.render": "the coarse and fine renders (the field kernels' forwards), the "
                   "silhouette, eikonal and photometric losses, their total",
    "vsrd.backward": "the parameters' requires_grad switches, the gradients (the field "
                     "kernels' backward) and their mean over a ray-sharded group",
    "vsrd.adam": "the Adam update",
    "vsrd.report": "the step's scalars and metrics; per chunk, their stack and copy to "
                   "the host",
}
STAGES = tuple(STAGE_MEANINGS)

DETECTOR_STEP = "det.step"
DETECTOR_BACKBONE = "det.backbone"
DETECTOR_TRANSFORMER = "det.transformer"
DETECTOR_MATCH = "det.match"
DETECTOR_LOSS = "det.loss"
DETECTOR_BACKWARD = "det.backward"
DETECTOR_OPTIM = "det.optim"
DETECTOR_STAGE_MEANINGS = {
    DETECTOR_BACKBONE: "the images' normalization, the backbone, the input projection and "
                       "the positions",
    DETECTOR_TRANSFORMER: "the encoder, the decoder and the heads on every decoder level",
    DETECTOR_MATCH: "every level's matching cost and their one JV solve",
    DETECTOR_LOSS: "the matched losses of every level and their total; the step's report "
                   "of them",
    DETECTOR_BACKWARD: "the gradients' reset and the backward pass",
    DETECTOR_OPTIM: "the gradients' clipping and the AdamW update",
}
DETECTOR_STAGES = tuple(DETECTOR_STAGE_MEANINGS)

OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is
    active, else the shared no-op ``OFF``."""
    return record_function(name) if _profiling() else OFF
