"""Drawing helpers for the diagnostic panels, in numpy (HWC images in [0,
1] or uint8, numpy in and out).

Counterpart of ``vsrd_tpu/visualization/drawers.py``, which draws with
OpenCV (``cv2.line`` of thickness 1 and 2, ``cv2.rectangle``, filled
``cv2.circle``, all 8-connected). Here OpenCV's rasterizers are written out
so that the uint8 canvas comes out the same byte for byte:

* a line of thickness 1 is the 8-connected line between its integer end
  points, after ``clipLine`` to the image (``_line``);
* a thicker line is clipped to the image grown by its thickness, then drawn
  as a convex quadrilateral around it in 16-bit sub-pixel fixed point
  (``_fill_convex``, whose outline is ``_line_subpixel``), with a filled
  midpoint circle at its caps (``_circle``).
"""

from __future__ import annotations

import math

import numpy as np

from ..data.transforms import _line_pixels

LINE_INDICES = [
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7],
]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _to_uint8(image):
    if image.dtype == np.uint8:
        return image.copy()
    return (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)


def _from_uint8(image, dtype):
    if dtype == np.uint8:
        return image
    return image.astype(np.float32) / 255.0


def _c_div(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on a ``width x height`` area: the clipped end points,
    or None when the segment misses it."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _put(canvas, xs, ys, color):
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    h, w = canvas.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[inside], xs[inside]] = color


def _line(canvas, p1, p2, color):
    """An 8-connected line between integer points (OpenCV's ``Line``:
    ``LineIterator`` after ``clipLine`` when an end lies outside)."""
    h, w = canvas.shape[:2]
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    xs, ys = _line_pixels(np.asarray([[x1, y1]]), np.asarray([[x2, y2]]))
    _put(canvas, xs, ys, color)


def _line_subpixel(h, w, p1, p2):
    """OpenCV's ``Line2``: the pixels ``(xs, ys)`` of a line between points
    in 16.16 fixed point, one per step along its major axis and then its end
    point, after ``clipLine`` to the image scaled by 2^16 (None when the
    line misses it)."""
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return None
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    half = XY_ONE >> 1
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _c_div(dy << XY_SHIFT, ax | 1)
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 2, dtype=np.int64)
        xs = ((x1 + half) >> XY_SHIFT) + k
        ys = (y1 + half + k * step) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _c_div(dx << XY_SHIFT, ay | 1)
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 2, dtype=np.int64)
        xs = (x1 + half + k * step) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + k
    xs[-1], ys[-1] = (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT
    return xs, ys


def _hline(canvas, y, x1, x2, color):
    w = canvas.shape[1]
    if x2 >= 0 and x1 < w:
        canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color


def _spans(w, rows, x1, x2):
    """The pixels ``(xs, ys)`` of ``_hline`` on each row of ``rows``
    (inside the image) at once."""
    keep = (x2 >= 0) & (x1 < w)
    rows, x1, x2 = rows[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
    counts = x2 - x1 + 1
    start = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(x1, counts) + np.arange(counts.sum()) - start, np.repeat(rows, counts)


def _fill_rows(h, w, xs, ys):
    """The row spans of OpenCV's ``FillConvexPoly`` between the two edge
    walkers, whose x steps by a rounded per-row increment from the vertex
    where each edge was taken up: a list of ``(xs, ys)`` pixel arrays."""
    n = len(xs)
    delta = XY_ONE >> 1
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return []
    ymax = min(ymax, h - 1)
    idx, di = [imin, imin], [1, n - 1]
    x, dx, ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    edges = n
    y = ymin
    spans = []
    while y <= ymax:
        for i in range(2):
            if y < ye[i]:
                continue
            idx0 = idx[i]
            nxt = (idx0 + di[i]) % n
            while True:
                budget = edges
                edges -= 1
                if budget <= 0:
                    break
                ty = (ys[nxt] + delta) >> XY_SHIFT
                if ty > y:
                    ye[i] = ty
                    dx[i] = _c_div((xs[nxt] - xs[idx0]) * 2 + (ty - y), 2 * (ty - y))
                    x[i] = xs[idx0]
                    idx[i] = nxt
                    break
                idx0 = nxt
                nxt = (nxt + di[i]) % n
        if edges < 0:
            return spans
        # rows y .. stop - 1 change nothing but the walkers' x
        stop = min(ye[0], ye[1], ymax + 1)
        rows = np.arange(max(y, 0), stop, dtype=np.int64)
        a = x[0] + dx[0] * (rows - y)
        b = x[1] + dx[1] * (rows - y)
        spans.append(_spans(w, rows, (np.minimum(a, b) + delta) >> XY_SHIFT,
                            (np.maximum(a, b) + delta) >> XY_SHIFT))
        x = [x[0] + dx[0] * (stop - y), x[1] + dx[1] * (stop - y)]
        y = stop
    return spans


def _fill_convex(canvas, points, color):
    """OpenCV's ``FillConvexPoly`` (8-connected) of a convex polygon with
    vertices in 16.16 fixed point: its outline by ``_line_subpixel``, then
    its rows (``_fill_rows``), all of one color and so written at once."""
    h, w = canvas.shape[:2]
    outline = [_line_subpixel(h, w, points[i - 1], points[i]) for i in range(len(points))]
    pixels = [p for p in outline if p is not None]
    pixels += _fill_rows(h, w, [p[0] for p in points], [p[1] for p in points])
    if pixels:
        _put(canvas, np.concatenate([p[0] for p in pixels]),
             np.concatenate([p[1] for p in pixels]), color)


def _circle(canvas, center, radius, color):
    """OpenCV's filled ``Circle`` (8-connected, integer centre and radius):
    the midpoint circle's horizontal spans."""
    h, w = canvas.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h:
                _hline(canvas, y, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(canvas, p0, p1, color, thickness, caps=3):
    """OpenCV's ``ThickLine`` of integer end points: thickness 1 is
    ``_line``; thicker, the quadrilateral of half-width thickness/2 around
    the segment and a filled circle of radius round(thickness / 2) at the
    caps named by ``caps`` (bit 0 the start, bit 1 the end)."""
    if thickness <= 1:
        _line(canvas, p0, p1, color)
        return
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    shifted = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (shifted + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)     # cvRound: half to even
        _fill_convex(canvas, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                              (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], color)
    radius = (shifted + (XY_ONE >> 1)) >> XY_SHIFT
    for bit, point in ((1, p0), (2, p1)):
        if caps & bit:
            _circle(canvas, (((point[0] + (XY_ONE >> 1)) >> XY_SHIFT),
                             ((point[1] + (XY_ONE >> 1)) >> XY_SHIFT)), radius, color)


def line(canvas, pt1, pt2, color, thickness=1):
    """``cv2.line(canvas, pt1, pt2, color, thickness)`` (LINE_8) in place. A
    thick line is first clipped to the image grown by its thickness on
    every side, as OpenCV does, which moves its polygon's corners."""
    if thickness > 1:
        h, w = canvas.shape[:2]
        t = int(thickness)
        clipped = _clip_line(w + 2 * t, h + 2 * t, int(pt1[0]) + t, int(pt1[1]) + t,
                             int(pt2[0]) + t, int(pt2[1]) + t)
        if clipped is None:
            return canvas
        pt1, pt2 = (clipped[0] - t, clipped[1] - t), (clipped[2] - t, clipped[3] - t)
    _thick_line(canvas, pt1, pt2, np.asarray(color, np.uint8), thickness)
    return canvas


def rectangle(canvas, pt1, pt2, color, thickness=1):
    """``cv2.rectangle(canvas, pt1, pt2, color, thickness)`` (LINE_8, an
    outline) in place: the closed polyline of its four corners, each edge
    capped at its end."""
    color = np.asarray(color, np.uint8)
    corners = [(pt1[0], pt1[1]), (pt2[0], pt1[1]), (pt2[0], pt2[1]), (pt1[0], pt2[1])]
    for i in range(4):
        _thick_line(canvas, corners[i - 1], corners[i], color, thickness, caps=2)
    return canvas


def circle(canvas, center, radius, color):
    """``cv2.circle(canvas, center, radius, color, -1)`` (filled, LINE_8) in
    place."""
    _circle(canvas, center, int(radius), np.asarray(color, np.uint8))
    return canvas


def _clip_line_to_front(p1, p2, epsilon=1e-6):
    """Clip a camera-space segment to z > 0; returns None if fully behind."""
    if p1[2] <= 0 and p2[2] <= 0:
        return None
    if p1[2] < p2[2]:
        p1, p2 = p2, p1
    if p2[2] <= 0:
        w = p1[2] / max(p1[2] - p2[2], epsilon)
        p2 = p1 + (p2 - p1) * min(w, 1.0)
    return p1, p2


def draw_boxes_3d(image, boxes_3d, intrinsic_matrix, line_indices=None,
                  color=(255, 255, 255), thickness=2):
    """Draw camera-space 8-corner wireframes with front clipping; pixel
    coordinates are truncated to integers, as ``astype(int)`` does."""
    canvas = _to_uint8(image)
    line_indices = line_indices or LINE_INDICES
    boxes_3d = np.asarray(boxes_3d, np.float64).reshape(-1, 8, 3)
    k = np.asarray(intrinsic_matrix, np.float64)
    for box in boxes_3d:
        if not np.all(np.isfinite(box)):
            continue
        for i, j in line_indices:
            clipped = _clip_line_to_front(box[i].copy(), box[j].copy())
            if clipped is None:
                continue
            p1, p2 = clipped
            a = k @ p1
            b = k @ p2
            a = (a[:2] / max(a[2], 1e-6)).astype(int)
            b = (b[:2] / max(b[2], 1e-6)).astype(int)
            line(canvas, a, b, color, thickness)
    return _from_uint8(canvas, np.asarray(image).dtype)


def draw_boxes_bev(image, boxes_3d, x_range=(-50.0, 50.0), z_range=(0.0, 100.0),
                   color=(0, 0, 255), thickness=2, draw_grid=True):
    """Bird's-eye-view footprints (x/z plane) on a square canvas, pixel
    coordinates truncated to integers."""
    canvas = _to_uint8(image)
    h, w = canvas.shape[:2]
    if draw_grid:
        for gx in range(0, w, w // 10):
            line(canvas, (gx, 0), (gx, h - 1), (200, 200, 200), 1)
        for gz in range(0, h, h // 10):
            line(canvas, (0, gz), (w - 1, gz), (200, 200, 200), 1)

    def to_pixel(point):
        px = (point[0] - x_range[0]) / (x_range[1] - x_range[0]) * (w - 1)
        pz = (1.0 - (point[2] - z_range[0]) / (z_range[1] - z_range[0])) * (h - 1)
        return int(px), int(pz)

    boxes_3d = np.asarray(boxes_3d, np.float64).reshape(-1, 8, 3)
    for box in boxes_3d:
        if not np.all(np.isfinite(box)):
            continue
        points = [to_pixel(p) for p in box[:4]]   # the top face shares the footprint
        for a, b in zip(points, points[1:] + points[:1]):
            line(canvas, a, b, color, thickness)
    return _from_uint8(canvas, np.asarray(image).dtype)


def draw_boxes_2d(image, boxes_2d, color=(0, 255, 0), thickness=2):
    canvas = _to_uint8(image)
    for box in np.asarray(boxes_2d).reshape(-1, 2, 2):
        rectangle(canvas, tuple(np.asarray(box[0], int)), tuple(np.asarray(box[1], int)), color,
                  thickness)
    return _from_uint8(canvas, np.asarray(image).dtype)


def draw_points_2d(image, points_2d, color=(255, 0, 0), radius=2):
    """Filled dots of ``radius`` at the points (truncated to integers)."""
    canvas = _to_uint8(image)
    for point in np.asarray(points_2d).reshape(-1, 2):
        circle(canvas, tuple(point.astype(int)), radius, color)
    return _from_uint8(canvas, np.asarray(image).dtype)


def draw_masks(image, masks, alpha=0.5, seed=0):
    """Alpha-blend per-instance masks with distinct colors."""
    image = np.asarray(image, np.float32)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    rng = np.random.default_rng(seed)
    out = image.copy()
    for mask in np.asarray(masks):
        color = rng.random(3) * 0.8 + 0.2
        # the blend of the masked pixels alone; the canvas takes the blend's
        # dtype, as np.where over the whole canvas would give it (float64
        # from the first mask on, since the colors are)
        pixels = np.flatnonzero(mask > 0.5)
        mixed = out.reshape(-1, 3)[pixels] * (1 - alpha) + color * alpha
        if mixed.dtype != out.dtype:
            out = out.astype(mixed.dtype)
        out.reshape(-1, 3)[pixels] = mixed
    return out
