"""Learnable 3D box parameters — the "detector" of the per-frame
optimization — and their decoding into boxes.

Counterpart of ``vsrd_tpu/models/box_parameters.py``: a plain dict of
tensors plus pure decode functions. Instance counts are padded to a
fixed maximum; the validity mask travels with the frame.
"""

from __future__ import annotations

import torch

from ..ops.geometry import rotation_matrix_y_from_cos_sin

# KITTI-360 "evaluation" corner order.
UNIT_BOX_CORNERS = (
    (-1.0, -1.0, +1.0),
    (+1.0, -1.0, +1.0),
    (+1.0, -1.0, -1.0),
    (-1.0, -1.0, -1.0),
    (-1.0, +1.0, +1.0),
    (+1.0, +1.0, +1.0),
    (+1.0, +1.0, -1.0),
    (-1.0, +1.0, -1.0),
)

DEFAULT_LOCATION_RANGE = (
    (-50.0, 1.55 - 1.75 / 2.0 - 5.0, 0.0),
    (+50.0, 1.55 - 1.75 / 2.0 + 5.0, 100.0),
)
DEFAULT_DIMENSION_RANGE = ((0.75, 0.75, 1.5), (1.00, 1.00, 2.5))


def init_box_parameters(
    generator: torch.Generator,
    batch_size: int,
    num_instances: int,
    num_features: int = 256,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    """Initial parameters. As in the reference, ONE random embedding is
    shared by every instance; instances differ only by their boxes until
    gradients pull them apart. ``generator`` must live on ``device``, which
    defaults to the generator's."""
    device = generator.device if device is None else device
    embedding = torch.rand(num_features, generator=generator, device=device)
    return {
        "locations": torch.zeros(batch_size, num_instances, 3, device=device),
        "dimensions": torch.zeros(batch_size, num_instances, 3, device=device),
        "orientations": torch.tensor([1.0, 0.0], device=device)
        .repeat(batch_size, num_instances, 1),
        "embeddings": embedding.repeat(batch_size, num_instances, 1),
    }


def _range(bounds, like: torch.Tensor):
    lo, hi = (torch.tensor(r, dtype=like.dtype, device=like.device) for r in bounds)
    return lo, hi


def decode_location(locations, location_range=DEFAULT_LOCATION_RANGE):
    lo, hi = _range(location_range, locations)
    return lo + (hi - lo) * torch.sigmoid(locations)


def decode_dimension(dimensions, dimension_range=DEFAULT_DIMENSION_RANGE):
    lo, hi = _range(dimension_range, dimensions)
    return lo + (hi - lo) * torch.sigmoid(dimensions)


def decode_orientation(orientations):
    """(cos, sin) logits -> y-axis rotation matrices."""
    norm = torch.linalg.vector_norm(orientations, dim=-1, keepdim=True)
    unit = orientations / torch.clamp(norm, min=1e-12)
    return rotation_matrix_y_from_cos_sin(unit[..., 0], unit[..., 1])


def decode_box_3d(locations, dimensions, orientations):
    """(loc [..., 3], half-dims [..., 3], R [..., 3, 3]) -> corners [..., 8, 3]."""
    unit = torch.tensor(UNIT_BOX_CORNERS, dtype=dimensions.dtype, device=dimensions.device)
    corners = unit * dimensions[..., None, :]
    corners = corners @ orientations.transpose(-2, -1)
    return corners + locations[..., None, :]


def _encode(boxes_3d):
    """Corners [..., 8, 3] -> locations, full (width, height, length) and
    the unit (cos, sin) of the yaw, from edge means in the evaluation
    corner order."""
    locations = torch.mean(boxes_3d, dim=-2)

    def edge_mean(a, b):
        return torch.mean(torch.linalg.vector_norm(boxes_3d[..., a, :] - boxes_3d[..., b, :],
                                                   dim=-1), dim=-1)

    widths = edge_mean([1, 2, 6, 5], [0, 3, 7, 4])
    heights = edge_mean([4, 5, 6, 7], [0, 1, 2, 3])
    lengths = edge_mean([1, 0, 4, 5], [2, 3, 7, 6])
    dimensions = torch.stack([widths, heights, lengths], dim=-1)
    direction = torch.mean(boxes_3d[..., [1, 0, 4, 5], :] - boxes_3d[..., [2, 3, 7, 6], :],
                           dim=-2)
    cos_sin = direction[..., [2, 0]]
    cos_sin = cos_sin / torch.clamp(torch.linalg.vector_norm(cos_sin, dim=-1, keepdim=True),
                                    min=1e-12)
    return locations, dimensions, cos_sin


def encode_box_3d(boxes_3d):
    """Corners [..., 8, 3] -> (locations, half-dimensions, rotation matrices),
    the inverse of ``decode_box_3d`` on boxes it made."""
    locations, dimensions, cos_sin = _encode(boxes_3d)
    return (locations, dimensions / 2.0,
            rotation_matrix_y_from_cos_sin(cos_sin[..., 0], cos_sin[..., 1]))


def encode_box_3d_yaw(boxes_3d):
    """Corners [..., 8, 3] -> (locations, full dimensions, yaw angle), the
    form prediction conversion writes."""
    locations, dimensions, cos_sin = _encode(boxes_3d)
    return locations, dimensions, torch.atan2(cos_sin[..., 1], cos_sin[..., 0])


def decode_boxes(params: dict, location_range=DEFAULT_LOCATION_RANGE,
                 dimension_range=DEFAULT_DIMENSION_RANGE) -> dict:
    """Box parameters -> corners, locations, half-dimensions, rotations."""
    locations = decode_location(params["locations"], location_range)
    dimensions = decode_dimension(params["dimensions"], dimension_range)
    orientations = decode_orientation(params["orientations"])
    return {
        "boxes_3d": decode_box_3d(locations, dimensions, orientations),
        "locations": locations,
        "dimensions": dimensions,
        "orientations": orientations,
        "embeddings": params["embeddings"],
    }
