"""Host-side data transforms of the labeling driver, in numpy and scipy.

Counterpart of the driver's chain in ``vsrd_tpu/data/transforms.py``
(``kitti360.default_transforms``): ``Resizer``, ``MaskAreaFilter``,
``MaskRefiner``, ``BoxGenerator``, ``BoxSizeFilter``, ``SoftRasterizer`` and
``polygon_distance_map``. The JAX package calls OpenCV for three steps;
here each is written out so that it gives OpenCV's pixels exactly, because
the soft masks that come out are the optimization's only supervision:

* ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)``, source pixel
  ``floor(x * src / dst)``; ``resize_linear`` (the image, read only for the
  photometric branch): ``cv2.resize(..., INTER_LINEAR)`` of a float image;
  ``resize_pil_bilinear`` (the detector's images): PIL's ``Image.resize(...,
  BILINEAR)`` of a uint8 image;
* ``external_contours``: ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)``, the outer borders of the 8-connected components
  that touch the outer background, each traced by Suzuki-Abe border
  following from its first pixel in raster order, in OpenCV's order (last
  found first); ``largest_contour`` picks the one ``cv2.contourArea``
  (shoelace) would;
* ``fill_polygon``: ``cv2.fillPoly(..., lineType=LINE_8)`` of one integer
  polygon: the 8-connected line of every edge, and the pixels of every row
  between even-odd pairs of the edges' 16.16 fixed-point crossings.

Transforms are callables taking and returning a sample dict with keys
``masks [N, H, W] f32``, ``labels [N]``, ``boxes_3d [N, 8, 3]``,
``instance_ids [N]``, ``intrinsic_matrix``, ``extrinsic_matrix`` and
``image_size (H, W)``, plus the keys they add, and ``image [H, W, C] f32``
when the image was read (the photometric branch reads it; the labeling
path otherwise carries only its size). The augmentations for the detector
leg are not ported.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), bool)


def resize_nearest(array: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(array, (W, H), interpolation=cv2.INTER_NEAREST)`` on the
    two leading axes."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = array.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return array.copy()
    rows = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / in_h))).astype(np.int64),
                      in_h - 1)
    cols = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / in_w))).astype(np.int64),
                      in_w - 1)
    return array[rows[:, None], cols[None, :]]


def _linear_taps(src: int, dst: int):
    """OpenCV's bilinear taps along one axis: source index pairs and their
    float32 weights, from the pixel-centre map ``(d + 0.5) src/dst - 0.5``
    in double precision (its fraction rounded to float32), clamped to the
    first and last pixel."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    low, high = s < 0, s >= src - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = src - 1
    return s, np.minimum(s + 1, src - 1), np.float32(1.0) - f, f


def resize_linear(image: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(image, (W, H), interpolation=cv2.INTER_LINEAR)`` of a
    float32 image ``[H, W(, C)]``: each source row interpolated along x,
    then the rows along y, in float32, as OpenCV does; an exact halving in
    both axes is OpenCV's 2x2 mean (it takes INTER_AREA's fast path there);
    the same size is a copy."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = image.shape[:2]
    image = np.asarray(image, np.float32)
    if (in_h, in_w) == (out_h, out_w):
        return image.copy()
    if (in_h, in_w) == (2 * out_h, 2 * out_w):
        top, bottom = image[0::2], image[1::2]
        return ((top[:, 0::2] + top[:, 1::2]) + bottom[:, 0::2] + bottom[:, 1::2]) * np.float32(
            0.25)
    x0, x1, a0, a1 = _linear_taps(in_w, out_w)
    y0, y1, b0, b1 = _linear_taps(in_h, out_h)
    extra = (None,) * (image.ndim - 2)
    rows = image[:, x0] * a0[(slice(None), *extra)] + image[:, x1] * a1[(slice(None), *extra)]
    return (rows[y0] * b0[(slice(None), None, *extra)]
            + rows[y1] * b1[(slice(None), None, *extra)])


_PIL_PRECISION_BITS = 22      # Pillow's 8-bit resampling: 32 - 8 - 2


def _pil_bilinear_taps(src: int, dst: int):
    """Pillow's bilinear taps along one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): per output pixel, ``ksize`` source indices
    and their coefficients in 22-bit fixed point. On a shrink the triangle
    widens by the scale; taps past a pixel's window weigh 0."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(dst) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)   # C casts truncate
    xmax = np.minimum((center + support + 0.5).astype(np.int64), src) - xmin
    x = np.arange(ksize)[None, :]
    inside = x < xmax[:, None]
    w = np.maximum(1.0 - np.abs((x + xmin[:, None] - center[:, None] + 0.5) / filterscale), 0.0)
    w = np.where(inside, w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, -0.5 + w * (1 << _PIL_PRECISION_BITS),
                     0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    index = np.minimum(xmin[:, None] + x, src - 1)
    return index, np.where(inside, fixed, 0)


def _pil_pass(pixels: np.ndarray, axis: int, size: int) -> np.ndarray:
    """One of Pillow's two passes over ``axis`` of a uint8 image: the
    fixed-point sum rounded by its half bit, shifted and clipped to uint8."""
    index, coef = _pil_bilinear_taps(pixels.shape[axis], size)
    taken = np.take(pixels, index, axis=axis).astype(np.int64)   # axis -> (size, ksize)
    shape = [1] * taken.ndim
    shape[axis], shape[axis + 1] = coef.shape
    acc = (taken * coef.reshape(shape)).sum(axis=axis + 1) + (1 << (_PIL_PRECISION_BITS - 1))
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_pil_bilinear(image: np.ndarray, size) -> np.ndarray:
    """``Image.fromarray(image).resize((W, H), Image.BILINEAR)`` of a uint8
    image ``[H, W(, C)]``: Pillow's convolution resampling, whose triangle
    filter widens by the scale factor on a shrink (so it is not OpenCV's
    INTER_LINEAR, ``resize_linear``), a horizontal pass then a vertical one
    with 22-bit fixed-point coefficients and a uint8 clip between them; an
    axis of unchanged size is not resampled."""
    out_h, out_w = int(size[0]), int(size[1])
    pixels = np.asarray(image, np.uint8)
    if pixels.shape[1] != out_w:
        pixels = _pil_pass(pixels, 1, out_w)
    if pixels.shape[0] != out_h:
        pixels = _pil_pass(pixels, 0, out_h)
    return pixels.copy() if pixels is image else pixels


def _trace_outer_border(flat: bytes, width: int, start: int) -> list[int]:
    """Suzuki-Abe border following of the outer border that starts at the
    flat index ``start`` of a zero-bordered image (row length ``width``),
    with CHAIN_APPROX_SIMPLE: a point is kept where the chain turns.
    Returns the kept points' flat indices, in OpenCV's order."""
    # chain directions 0-7 as OpenCV numbers them: right, up-right, up, up-left,
    # left, down-left, down, down-right (y grows downwards)
    deltas = (1, -width + 1, -width, -width - 1, -1, width - 1, width, width + 1)
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = start + deltas[s]
        if flat[i1] or s == s_end:
            break
    if s == s_end:
        return [start]                       # a single pixel
    points = []
    i3, prev_s = start, s ^ 4
    while True:
        s_end = s
        while True:
            s += 1
            i4 = i3 + deltas[s & 7]
            if flat[i4]:
                break
        s &= 7
        if s != prev_s:
            points.append(i3)
            prev_s = s
        if i4 == start and i3 == i1:
            return points
        i3 = i4
        s = (s + 4) & 7


def external_contours(binary: np.ndarray) -> list[np.ndarray]:
    """The outer borders of the components of ``binary`` [H, W] that are not
    inside a hole of another, as ``[K, 2]`` int32 (x, y) vertices: what
    ``cv2.findContours(binary, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` gives,
    in its order."""
    binary = np.asarray(binary, bool)
    rows = np.flatnonzero(binary.any(axis=1))
    if not len(rows):
        return []
    cols = np.flatnonzero(binary.any(axis=0))
    r0, c0 = int(rows[0]), int(cols[0])
    crop = np.pad(binary[r0:rows[-1] + 1, c0:cols[-1] + 1], 1)   # a zero frame, as OpenCV's
    labels, _ = ndimage.label(crop, structure=_EIGHT)
    background, _ = ndimage.label(~crop)                       # 4-connected
    outer = background == background[0, 0]
    touching = np.unique(labels[ndimage.binary_dilation(outer) & crop])
    flat_labels = labels.ravel()
    foreground = np.flatnonzero(flat_labels)
    found, first = np.unique(flat_labels[foreground], return_index=True)
    starts = foreground[first[np.isin(found, touching)]]      # first pixel in raster order
    width = crop.shape[1]
    flat = crop.astype(np.uint8).tobytes()
    contours = []
    for start in sorted(starts.tolist(), reverse=True):        # OpenCV: last found first
        points = np.asarray(_trace_outer_border(flat, width, start), np.int64)
        contours.append(np.stack([points % width - 1 + c0, points // width - 1 + r0],
                                 axis=-1).astype(np.int32))
    return contours


def contour_area_twice(contour: np.ndarray) -> int:
    """Twice ``cv2.contourArea`` of an integer contour (shoelace), exactly."""
    x = contour[:, 0].astype(np.int64)
    y = contour[:, 1].astype(np.int64)
    return abs(int(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x)))


def largest_contour(mask: np.ndarray, threshold: float = 0.5) -> np.ndarray | None:
    """The external contour of ``mask > threshold`` with the largest area,
    the first in OpenCV's order among equals (``max(contours,
    key=cv2.contourArea)``), or None."""
    best, best_area = None, -1
    for contour in external_contours(mask > threshold):
        area = contour_area_twice(contour)
        if area > best_area:
            best, best_area = contour, area
    return best


def _line_pixels(p0: np.ndarray, p1: np.ndarray):
    """The pixels of OpenCV's 8-connected lines (``LineIterator``, left to
    right) from ``p0 [E, 2]`` to ``p1 [E, 2]``: (x, y) arrays."""
    swap = p1[:, 0] < p0[:, 0]
    start = np.where(swap[:, None], p1, p0)
    end = np.where(swap[:, None], p0, p1)
    dx = end[:, 0] - start[:, 0]
    dy = end[:, 1] - start[:, 1]
    step_y = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vertical = dy > dx
    major = np.where(vertical, dy, dx)
    minor = np.where(vertical, dx, dy)
    count = major + 1
    edge = np.repeat(np.arange(len(p0)), count)
    k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    big, small = major[edge], minor[edge]
    # minor steps after k major ones: the error term starts at major - 2 minor,
    # loses 2 minor a step and gains 2 major with each minor step, taken
    # while it is negative: ceil((2 minor k - major) / (2 major))
    m = -((big - 2 * small * k) // np.maximum(2 * big, 1))
    along, across = np.where(vertical[edge], m, k), np.where(vertical[edge], k, m)
    return start[edge, 0] + along, start[edge, 1] + step_y[edge] * across


def fill_polygon(shape, polygon: np.ndarray) -> np.ndarray:
    """``cv2.fillPoly(zeros(shape), [polygon], 1)`` with 8-connected lines
    and integer (x, y) vertices, as a bool mask."""
    h, w = shape
    out = np.zeros((h, w), bool)
    p1 = np.asarray(polygon, np.int64).reshape(-1, 2)
    p0 = np.roll(p1, 1, axis=0)                     # edge i runs from v[i-1] to v[i]
    xs, ys = _line_pixels(p0, p1)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out[ys[inside], xs[inside]] = True

    # spans: each non-horizontal edge crosses rows [y_top, y_bottom) at
    # x_top + (y - y_top) * dx in 16.16 fixed point, dx truncated toward zero
    slanted = p0[:, 1] != p1[:, 1]
    if slanted.sum() < 2:
        return out
    a, b = p0[slanted], p1[slanted]
    num = (b[:, 0] - a[:, 0]) << 16
    den = b[:, 1] - a[:, 1]
    dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
    down = a[:, 1] < b[:, 1]
    y_top = np.where(down, a[:, 1], b[:, 1])
    height = np.abs(den)
    x_top = np.where(down, a[:, 0], b[:, 0]) << 16
    edge = np.repeat(np.arange(len(a)), height)
    offset = np.arange(height.sum()) - np.repeat(np.cumsum(height) - height, height)
    y = y_top[edge] + offset
    x = x_top[edge] + offset * dx[edge]
    order = np.lexsort((x, y))
    x, y = x[order], y[order]
    # even-odd pairs of a row: the pixels whose centres lie between them
    left, right, row = (x[0::2] + 0xFFFF) >> 16, x[1::2] >> 16, y[0::2]
    keep = (row >= 0) & (row < h) & (left < w) & (right >= 0)
    left = np.clip(left[keep], 0, w - 1)
    right = np.clip(right[keep], 0, w - 1)
    row = row[keep]
    change = np.zeros((h, w + 1), np.int32)
    np.add.at(change, (row, left), 1)
    np.add.at(change, (row, right + 1), -1)
    return out | (np.cumsum(change, axis=1)[:, :w] > 0)


class Resizer:
    """Resize the image (bilinear, when the sample holds it) and the masks
    (nearest) to ``image_size`` and rescale K."""

    def __init__(self, image_size, image_interp_mode="bilinear", masks_interp_mode="nearest"):
        if masks_interp_mode != "nearest":
            raise NotImplementedError("the port resizes masks with nearest interpolation only")
        self.image_size = tuple(image_size)

    def __call__(self, sample):
        h, w = sample["image_size"]
        sy = self.image_size[0] / h
        sx = self.image_size[1] / w
        sample = dict(sample, image_size=self.image_size)
        if sample.get("image") is not None:
            sample["image"] = resize_linear(sample["image"], self.image_size)
        masks = sample.get("masks")
        if masks is not None:
            if len(masks):
                sample["masks"] = np.stack([resize_nearest(m, self.image_size) for m in masks])
            else:
                sample["masks"] = np.empty((0, *self.image_size), dtype=masks.dtype)
        k = sample.get("intrinsic_matrix")
        if k is not None:
            scale = np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], dtype=k.dtype)
            sample["intrinsic_matrix"] = scale @ k
        return sample


class MaskAreaFilter:
    """Drop instances whose binary mask area is below a threshold."""

    INSTANCE_KEYS = ("masks", "labels", "boxes_3d", "boxes_2d", "instance_ids")

    def __init__(self, min_mask_area, threshold=0.5):
        self.min_mask_area = min_mask_area
        self.threshold = threshold

    def __call__(self, sample):
        areas = (sample["masks"] > self.threshold).sum(axis=(-2, -1))
        return _keep_instances(sample, areas >= self.min_mask_area)


def _keep_instances(sample, keep):
    sample = dict(sample)
    for key in MaskAreaFilter.INSTANCE_KEYS:
        if key in sample and sample[key] is not None:
            sample[key] = sample[key][keep]
    return sample


class BoxGenerator:
    """2D boxes [[x0, y0], [x1, y1]] from the binary masks."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold

    def __call__(self, sample):
        masks = sample["masks"]
        boxes = np.zeros((len(masks), 2, 2), np.float32)
        for i, mask in enumerate(masks):
            ys, xs = np.nonzero(mask > self.threshold)
            if len(ys):
                boxes[i] = [[xs.min(), ys.min()], [xs.max(), ys.max()]]
        return dict(sample, boxes_2d=boxes)


class BoxSizeFilter:
    """Drop instances whose 2D box's shorter side is below a threshold."""

    def __init__(self, min_box_size):
        self.min_box_size = min_box_size

    def __call__(self, sample):
        boxes = sample["boxes_2d"]
        sizes = (boxes[:, 1] - boxes[:, 0]).min(axis=-1)
        return _keep_instances(sample, sizes >= self.min_box_size)


class MaskRefiner:
    """Re-fill each mask from its largest external contour."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold

    def __call__(self, sample):
        masks = sample["masks"]
        if masks.size == 0:
            return sample
        refined = np.zeros_like(masks)
        for i, mask in enumerate(masks):
            polygon = largest_contour(mask, self.threshold)
            if polygon is not None:
                refined[i] = fill_polygon(mask.shape, polygon).astype(masks.dtype)
        return dict(sample, masks=refined)


def polygon_distance_map(polygon: np.ndarray, image_size) -> np.ndarray:
    """Unsigned distance from each pixel to the polygon's boundary. Uses
    the native library when it is built (``data/native.py``), else the
    vectorized point-segment distance below."""
    from . import native

    fast = native.polygon_distance_map_native(polygon, image_size)
    if fast is not None:
        return fast
    h, w = image_size
    ys, xs = np.mgrid[0:h, 0:w]
    points = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    prev_v = polygon.astype(np.float32)
    sides = np.roll(prev_v, -1, axis=0) - prev_v                   # [V, 2]
    rel = points[:, None, :] - prev_v[None, :, :]                  # [P, V, 2]
    denom = np.sum(sides * sides, axis=-1) + 1e-6
    ratio = np.clip(np.sum(rel * sides[None], axis=-1) / denom[None], 0.0, 1.0)
    normals = rel - sides[None] * ratio[..., None]
    return np.linalg.norm(normals, axis=-1).min(axis=-1).reshape(h, w)


class SoftRasterizer:
    """mask -> largest polygon -> signed distance map -> sigmoid soft mask.
    Adds ``hard_masks`` and ``soft_masks``."""

    def __init__(self, threshold=0.5, temperature=10.0):
        self.threshold = threshold
        self.temperature = temperature

    def __call__(self, sample):
        masks = sample["masks"]
        if masks.size == 0:
            return dict(sample, hard_masks=masks, soft_masks=np.empty_like(masks))
        soft = np.zeros_like(masks, dtype=np.float32)
        for i, mask in enumerate(masks):
            polygon = largest_contour(mask, self.threshold)
            if polygon is None or len(polygon) < 3:
                soft[i] = mask
                continue
            inside = fill_polygon(mask.shape, polygon)
            distance = polygon_distance_map(polygon, mask.shape)
            sdf = np.where(inside, distance, -distance)
            with np.errstate(over="ignore"):          # far outside: exp -> inf, soft -> 0
                soft[i] = 1.0 / (1.0 + np.exp(-sdf / self.temperature))
        return dict(sample, hard_masks=masks, soft_masks=soft)
