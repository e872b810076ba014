"""3D / BEV box IoU by fixed-size convex polygon clipping, on the device.

Counterpart of ``vsrd_tpu/ops/iou3d.py``: a Sutherland-Hodgman clip with a
16-vertex buffer (two convex quadrilaterals intersect in at most 8
vertices), batched over a leading axis of box pairs, with no host
synchronisation. Corners follow the KITTI-360 "evaluation" order with z
up (the caller rotates by Rx(-pi/2)): corners 0-3 top face, 4-7 bottom.
"""

from __future__ import annotations

import torch

MAX_VERTS = 16


def _shoelace(verts, count):
    """Polygon area of ``verts [B, 16, 2]`` with ``count [B]`` vertices."""
    idx = torch.arange(MAX_VERTS, device=verts.device)
    valid = idx[None, :] < count[:, None]
    nxt = torch.where(idx[None, :] + 1 >= count[:, None], 0, idx[None, :] + 1)
    v_next = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    terms = verts[..., 0] * v_next[..., 1] - v_next[..., 0] * verts[..., 1]
    return 0.5 * torch.sum(torch.where(valid, terms, 0.0), dim=-1)


def _ensure_ccw(poly):
    """Reverse quadrilaterals ``[B, 4, 2]`` that are clockwise."""
    area2 = torch.sum(
        poly[..., 0] * torch.roll(poly[..., 1], -1, dims=-1)
        - torch.roll(poly[..., 0], -1, dims=-1) * poly[..., 1],
        dim=-1,
    )
    return torch.where((area2 < 0)[:, None, None], poly.flip(-2), poly)


def _line_intersection(s, e, cp1, cp2):
    """Intersection of segment lines (s, e) ``[B, 16, 2]`` with the clip
    edge lines (cp1, cp2) ``[B, 1, 2]``."""
    dc = cp1 - cp2
    dp = s - e
    n1 = cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0]
    n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
    denom = dc[..., 0] * dp[..., 1] - dc[..., 1] * dp[..., 0]
    n3 = 1.0 / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    return torch.stack(
        [(n1 * dp[..., 0] - n2 * dc[..., 0]) * n3,
         (n1 * dp[..., 1] - n2 * dc[..., 1]) * n3],
        dim=-1,
    )


def _clip_halfplane(verts, count, cp1, cp2):
    """One Sutherland-Hodgman pass against the (cp1 -> cp2) edge."""
    b = verts.shape[0]
    idx = torch.arange(MAX_VERTS, device=verts.device)[None, :]
    valid = idx < count[:, None]
    # an empty polygon (count 0) wraps to the last slot, as numpy-style
    # negative indexing does in the JAX version
    prev = torch.where(idx == 0, count[:, None] - 1, idx - 1) % MAX_VERTS
    s = torch.gather(verts, 1, prev[..., None].expand(-1, -1, 2))
    e = verts

    def inside(p):
        return (cp2[..., 0] - cp1[..., 0]) * (p[..., 1] - cp1[..., 1]) > (
            cp2[..., 1] - cp1[..., 1]
        ) * (p[..., 0] - cp1[..., 0])

    ins_s = inside(s)
    ins_e = inside(e)
    inter = _line_intersection(s, e, cp1, cp2)

    emit_inter = (ins_s != ins_e) & valid
    emit_e = ins_e & valid
    counts = emit_inter.long() + emit_e.long()
    offsets = torch.cumsum(counts, dim=-1) - counts

    # scatter into a buffer with one spare slot that absorbs the writes
    # of non-emitting vertices (the JAX version's mode="drop")
    pos_inter = torch.where(emit_inter, offsets, MAX_VERTS)
    pos_e = torch.where(emit_e, offsets + emit_inter.long(), MAX_VERTS)
    new_verts = torch.zeros(b, MAX_VERTS + 1, 2, dtype=verts.dtype, device=verts.device)
    new_verts = new_verts.scatter(1, pos_inter[..., None].expand(-1, -1, 2), inter)
    new_verts = new_verts.scatter(1, pos_e[..., None].expand(-1, -1, 2), e)
    return new_verts[:, :MAX_VERTS], torch.sum(counts, dim=-1)


def convex_polygon_intersection_area(poly1, poly2):
    """Intersection area of convex quadrilaterals ``[B, 4, 2]``."""
    poly1 = _ensure_ccw(poly1)
    poly2 = _ensure_ccw(poly2)
    b = poly1.shape[0]
    verts = torch.zeros(b, MAX_VERTS, 2, dtype=poly1.dtype, device=poly1.device)
    verts[:, :4] = poly1
    count = torch.full((b,), 4, dtype=torch.long, device=poly1.device)
    for i in range(4):
        cp1 = poly2[:, i : i + 1]
        cp2 = poly2[:, (i + 1) % 4 : (i + 1) % 4 + 1]
        verts, count = _clip_halfplane(verts, count, cp1, cp2)
    area = _shoelace(verts, count)
    return torch.where(count >= 3, torch.abs(area), 0.0)


def box_3d_iou(corners1: torch.Tensor, corners2: torch.Tensor):
    """3D and BEV IoU of 8-corner boxes ``[B, 8, 3]`` (z up).

    BEV rectangles from corners [3, 2, 1, 0] (x, y); vertical extent from
    corners 0 (top) and 4 (bottom). Returns ``(iou_3d [B], iou_bev [B])``.
    """
    order = [3, 2, 1, 0]
    rect1 = corners1[:, order, :2]
    rect2 = corners2[:, order, :2]

    def rect_area(rect):
        return torch.abs(
            0.5
            * torch.sum(
                rect[..., 0] * torch.roll(rect[..., 1], 1, dims=-1)
                - rect[..., 1] * torch.roll(rect[..., 0], 1, dims=-1),
                dim=-1,
            )
        )

    area1 = rect_area(rect1)
    area2 = rect_area(rect2)

    inter_area = convex_polygon_intersection_area(rect1, rect2)
    inter_area = torch.minimum(torch.minimum(area1, area2), inter_area)
    iou_bev = inter_area / (area1 + area2 - inter_area)

    zmax = torch.minimum(corners1[:, 0, 2], corners2[:, 0, 2])
    zmin = torch.maximum(corners1[:, 4, 2], corners2[:, 4, 2])
    inter_vol = inter_area * torch.clamp(zmax - zmin, min=0.0)

    def volume(c):
        a = torch.linalg.vector_norm(c[:, 0] - c[:, 1], dim=-1)
        b = torch.linalg.vector_norm(c[:, 1] - c[:, 2], dim=-1)
        h = torch.linalg.vector_norm(c[:, 0] - c[:, 4], dim=-1)
        return a * b * h

    iou_3d = inter_vol / (volume(corners1) + volume(corners2) - inter_vol)
    return iou_3d, iou_bev
