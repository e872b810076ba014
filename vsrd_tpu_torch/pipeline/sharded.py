"""Stacked frames for co-optimization on one card.

Counterpart of ``stack_frames`` in ``vsrd_tpu/pipeline/sharded.py``. The
JAX module's device mesh and ``shard_map`` training step (frames over a
``dp`` axis, rays over ``sp``) are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from .frame import FrameData


def stack_frames(frames: list[FrameData]) -> FrameData:
    """Stack equally shaped FrameData along a new leading frame axis.

    ``target_index`` becomes an int64 tensor ``[F]`` on the frames' device;
    ``gray_images`` stays ``None`` when no frame has them, and a mix of
    frames with and without them is refused."""
    first = frames[0]
    if any(f.image_size != first.image_size for f in frames):
        raise ValueError("stacked frames must share one image size")
    fields = {}
    for field in dataclasses.fields(FrameData):
        values = [getattr(f, field.name) for f in frames]
        if field.name == "image_size":
            fields[field.name] = first.image_size
        elif field.name == "target_index":
            fields[field.name] = torch.as_tensor([int(v) for v in values], device=first.device)
        elif field.name == "gray_images" and all(v is None for v in values):
            fields[field.name] = None
        elif field.name == "gray_images" and any(v is None for v in values):
            raise ValueError("stacked frames must all have gray_images or all lack them")
        else:
            fields[field.name] = torch.stack(values)
    return FrameData(**fields)
