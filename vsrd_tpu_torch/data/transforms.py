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
path otherwise carries only its size).

The seven augmentations of the JAX package follow, with its constructors,
``update_params`` and draw order: ``Cropper``, ``RandomHorizontalFlipper``,
``BoxJitter``, ``FractalBrownianMotion``, ``FastFractalBrownianMotion``
(its upsampling is ``resize_linear``), ``RandomConvolution`` (``filter2d``,
``cv2.filter2D`` written out) and ``ColorJitter``, whose hue step goes
through OpenCV's 8-bit HSV (``rgb_to_hsv`` and ``hsv_to_rgb``, equal to
``cv2.cvtColor`` byte for byte).
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
    """Resize the image (when the sample holds it) and the masks to
    ``image_size`` and rescale K. As in the JAX package, the image is
    resized bilinearly for ``image_interp_mode="bilinear"`` and by nearest
    neighbour otherwise, the masks by nearest neighbour for
    ``masks_interp_mode="nearest"`` and bilinearly otherwise (OpenCV's
    INTER_LINEAR and INTER_NEAREST, ``resize_linear`` and ``resize_nearest``)."""

    def __init__(self, image_size, image_interp_mode="bilinear", masks_interp_mode="nearest"):
        self.image_size = tuple(image_size)
        self.image_resize = resize_linear if image_interp_mode == "bilinear" else resize_nearest
        self.masks_resize = resize_nearest if masks_interp_mode == "nearest" else resize_linear

    def __call__(self, sample):
        h, w = sample["image_size"]
        sy = self.image_size[0] / h
        sx = self.image_size[1] / w
        sample = dict(sample, image_size=self.image_size)
        if sample.get("image") is not None:
            sample["image"] = self.image_resize(sample["image"], self.image_size)
        masks = sample.get("masks")
        if masks is not None:
            if len(masks):
                sample["masks"] = np.stack([self.masks_resize(m, self.image_size) for m in masks])
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


# ---- the augmentations (the detector leg's configs) ----
#
# Each draws from the ``np.random.Generator`` it is given (a fresh one by
# default), in the JAX classes' order, so that one seed gives the JAX
# package's draws; classes with ``update_params`` redraw there.


class Cropper:
    """Crop the image and masks to ``image_size`` at ``position`` (y, x) and
    shift K."""

    def __init__(self, position, image_size):
        self.position = tuple(position)
        self.image_size = tuple(image_size)

    def __call__(self, sample):
        y, x = self.position
        h, w = self.image_size
        sample = dict(sample)
        if sample.get("image") is not None:
            sample["image"] = sample["image"][y:y + h, x:x + w]
        masks = sample.get("masks")
        if masks is not None:
            sample["masks"] = masks[:, y:y + h, x:x + w]
        if "image_size" in sample:
            full_h, full_w = sample["image_size"]
            sample["image_size"] = (max(min(h, full_h - y), 0), max(min(w, full_w - x), 0))
        k = sample.get("intrinsic_matrix")
        if k is not None:
            shift = np.array([[1, 0, -x], [0, 1, -y], [0, 0, 1]], dtype=k.dtype)
            sample["intrinsic_matrix"] = shift @ k
        return sample


class RandomHorizontalFlipper:
    """Flip the image and masks horizontally with ``probability`` (drawn in
    ``update_params``) and flip K."""

    def __init__(self, probability=0.5, rng=None):
        self.probability = probability
        self.rng = rng or np.random.default_rng()
        self.update_params()

    def update_params(self):
        self.flip = bool(self.rng.random() < self.probability)

    def __call__(self, sample):
        if not self.flip:
            return sample
        image = sample.get("image")
        h, w = image.shape[:2] if image is not None else sample["image_size"]
        sample = dict(sample)
        if image is not None:
            sample["image"] = image[:, ::-1].copy()
        masks = sample.get("masks")
        if masks is not None:
            sample["masks"] = masks[:, :, ::-1].copy()
        k = sample.get("intrinsic_matrix")
        if k is not None:
            flip = np.array([[-1, 0, w - 1], [0, -1, h - 1], [0, 0, 1]], dtype=k.dtype)
            sample["intrinsic_matrix"] = flip @ k
        return sample


class BoxJitter:
    """Jitter ``crop_box`` [[x0, y0], [x1, y1]] by uniform scales of its size."""

    def __init__(self, scale_range, rng=None):
        self.scale_range = scale_range
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        crop_box = sample["crop_box"]
        sizes = crop_box[1] - crop_box[0]
        scales = self.rng.uniform(*self.scale_range, size=crop_box.shape)
        return dict(sample, crop_box=crop_box + sizes * scales)


class FractalBrownianMotion:
    """Add fractal Perlin noise to the image: ``num_octaves`` octaves, each at
    ``lacunarity`` times the last's resolution and ``persistence`` times its
    amplitude, then scaled by a uniform draw."""

    def __init__(self, amplitude, resolution, persistence, lacunarity, num_octaves, rng=None):
        self.amplitude = np.asarray(amplitude, np.float32)
        self.resolution = np.asarray(resolution, np.int64)
        self.persistence = persistence
        self.lacunarity = lacunarity
        self.num_octaves = num_octaves
        self.rng = rng or np.random.default_rng()

    def _perlin(self, image_size, amplitude, resolution):
        """One octave of Perlin noise at ``resolution`` gradient cells over
        ``image_size`` (padded to whole cells, cropped from the top left),
        normalized to [-amplitude, amplitude]."""
        image_size = np.asarray(image_size)
        resolution = np.maximum(resolution.astype(np.int64), 1)
        padding = (resolution - image_size % resolution) % resolution
        padded = image_size + padding
        reps = padded // resolution
        grid = [np.modf(np.linspace(0.0, r, s, endpoint=False))[0]
                for r, s in zip(resolution, padded)]
        py, px = np.meshgrid(*grid, indexing="ij")

        angles = 2.0 * np.pi * self.rng.random(tuple(resolution + 1))
        gradients = np.stack([np.cos(angles), np.sin(angles)], axis=0)
        gradients = np.repeat(gradients, reps[0], axis=1)
        gradients = np.repeat(gradients, reps[1], axis=2)
        g00 = gradients[:, :-reps[0], :-reps[1]]
        g10 = gradients[:, reps[0]:, :-reps[1]]
        g01 = gradients[:, :-reps[0], reps[1]:]
        g11 = gradients[:, reps[0]:, reps[1]:]

        def dot(gr, oy, ox):
            return (py - oy) * gr[0] + (px - ox) * gr[1]

        n00, n10 = dot(g00, 0, 0), dot(g10, 1, 0)
        n01, n11 = dot(g01, 0, 1), dot(g11, 1, 1)
        wy = 3 * py**2 - 2 * py**3
        wx = 3 * px**2 - 2 * px**3
        n0 = n00 + (n10 - n00) * wy
        n1 = n01 + (n11 - n01) * wy
        noise = n0 + (n1 - n0) * wx
        noise = (noise - noise.min()) / max(noise.max() - noise.min(), 1e-12)
        noise = (noise * 2.0 - 1.0) * amplitude
        return noise[padding[0]:, padding[1]:]

    def _octaves(self, size):
        return sum(self._perlin(size, self.amplitude * self.persistence**octave,
                                self.resolution * self.lacunarity**octave)
                   for octave in range(self.num_octaves))

    def _add(self, sample, noise):
        image = sample["image"]
        out = np.clip(image + noise[..., None] * self.rng.random(), 0.0, 1.0).astype(image.dtype)
        return dict(sample, image=out)

    def __call__(self, sample):
        return self._add(sample, self._octaves(np.asarray(sample["image"].shape[:2])))


class FastFractalBrownianMotion(FractalBrownianMotion):
    """``FractalBrownianMotion`` computed at 1/``downscale_factor`` of the
    image size and resized up bilinearly (``resize_linear``, OpenCV's
    INTER_LINEAR)."""

    def __init__(self, *args, downscale_factor, **kwargs):
        super().__init__(*args, **kwargs)
        self.downscale_factor = downscale_factor

    def __call__(self, sample):
        size = np.asarray(sample["image"].shape[:2])
        noise = self._octaves(np.maximum(size // self.downscale_factor, 1))
        return self._add(sample, resize_linear(noise.astype(np.float32), size))


def filter2d(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(image, -1, kernel)``: the correlation (no flip) of each
    channel with ``kernel`` anchored at its centre, the border reflected
    without repeating the edge (BORDER_REFLECT_101), summed in float64 and
    returned in ``image``'s dtype."""
    kh, kw = kernel.shape
    top, left = kh // 2, kw // 2
    pad = [(top, kh - 1 - top), (left, kw - 1 - left)] + [(0, 0)] * (image.ndim - 2)
    padded = np.pad(image.astype(np.float64), pad, mode="reflect")
    h, w = image.shape[:2]
    out = np.zeros(image.shape, np.float64)
    for i in range(kh):
        for j in range(kw):
            out += float(kernel[i, j]) * padded[i:i + h, j:j + w]
    return out.astype(image.dtype)


class RandomConvolution:
    """Blend the image with its correlation by a random normal kernel of a
    size drawn from ``kernel_sizes``, normalized to sum 1, by a uniform
    weight."""

    def __init__(self, kernel_sizes, rng=None):
        self.kernel_sizes = kernel_sizes
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image = sample["image"]
        k = int(self.rng.choice(self.kernel_sizes))
        weight = self.rng.normal(size=(k, k)).astype(np.float32)
        weight /= weight.sum() if abs(weight.sum()) > 1e-6 else 1.0
        convolved = filter2d(image, weight)
        alpha = self.rng.random()
        out = np.clip(image + (convolved - image) * alpha, 0.0, 1.0)
        return dict(sample, image=out.astype(image.dtype))


# OpenCV's 8-bit HSV (H in [0, 180)): RGB -> HSV in 12-bit fixed point with
# its division tables; HSV -> RGB in float32 with the products 1 - s h and
# 1 - s (1 - h) fused (OpenCV's build contracts them to FMAs), then to uint8
# by truncation in its SIMD blocks of HSV_SIMD_PIXELS pixels (AVX2: 8 lanes x
# 4 registers) and by rounding in the scalar tail of each row
_HSV_SHIFT = 12
_DIVISORS = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIVISORS)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _DIVISORS))]).astype(np.int64)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
HSV_SIMD_PIXELS = 32


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` of a uint8 image."""
    rgb = rgb.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    return np.stack([np.where(h < 0, h + 180, h), s, v], axis=-1).astype(np.uint8)


def _fused_one_minus(a, b):
    """1 - a b in float32 with one rounding, as an FMA gives it."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a uint8 image [H, W, 3]."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * (f32(6) / f32(180))
    s = hsv[..., 1].astype(f32) * (f32(1) / f32(255))
    v = hsv[..., 2].astype(f32) * (f32(1) / f32(255))
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([v, v * (f32(1) - s), v * _fused_one_minus(s, h),
                    v * _fused_one_minus(s, f32(1) - h)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], axis=-1)
    scaled = bgr[..., ::-1] * f32(255)
    width = hsv.shape[1]
    simd = np.arange(width) < width // HSV_SIMD_PIXELS * HSV_SIMD_PIXELS
    out = np.where(simd[:, None], np.trunc(scaled), np.rint(scaled))
    return np.clip(out, 0, 255).astype(np.uint8)


class ColorJitter:
    """Brightness, contrast, saturation and hue jitter of ``augmented_image``
    (or the image), in an order and with factors drawn in
    ``update_params``; the hue step turns the 8-bit hue of OpenCV's HSV."""

    def __init__(self, brightness=(1.0, 1.0), contrast=(1.0, 1.0), saturation=(1.0, 1.0),
                 hue=(0.0, 0.0), rng=None):
        self.ranges = dict(brightness=brightness, contrast=contrast, saturation=saturation,
                           hue=hue)
        self.rng = rng or np.random.default_rng()
        self.update_params()

    def update_params(self):
        self.factors = {name: self.rng.uniform(*bounds) for name, bounds in self.ranges.items()}
        self.order = self.rng.permutation(4)

    def _apply(self, image, name):
        factor = self.factors[name]
        if name == "brightness":
            return np.clip(image * factor, 0, 1)
        if name == "contrast":
            gray = image @ np.array([0.299, 0.587, 0.114], np.float32)
            mean = gray.mean()
            return np.clip(mean + (image - mean) * factor, 0, 1)
        if name == "saturation":
            gray = (image @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
            return np.clip(gray + (image - gray) * factor, 0, 1)
        hsv = rgb_to_hsv((image * 255).astype(np.uint8)).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(factor * 180)) % 180
        return hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32) / 255.0

    def __call__(self, sample):
        augmented = sample.get("augmented_image", sample["image"])
        names = ["brightness", "contrast", "saturation", "hue"]
        for index in self.order:
            augmented = self._apply(augmented, names[index])
        return dict(sample, augmented_image=augmented.astype(np.float32))
