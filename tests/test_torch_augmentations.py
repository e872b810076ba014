"""The port's seven augmentations (``vsrd_tpu_torch/data/transforms.py``)
against the JAX package's classes, and its OpenCV pieces against cv2.

Each class is built on both sides with ``np.random.default_rng(seed)`` and
applied to one seeded sample dict, so the two draw the same numbers in the
same order:

* ``Cropper``, ``RandomHorizontalFlipper`` and ``BoxJitter``: equal, the K
  matrices too; ``Resizer`` in each of its image and mask modes: equal where
  it takes the nearest pixel, within 1e-5 where it interpolates;
* ``FractalBrownianMotion`` within 1e-6 absolute, ``FastFractalBrownianMotion``
  within 1e-5 (its upsampling is ``resize_linear``, held to cv2.resize within
  2e-7 by ``tests/test_torch_png.py``), ``RandomConvolution`` within 1e-5
  at kernel sizes 3, 5 and 7 (``filter2d`` sums in float64, OpenCV in float32);
* ``ColorJitter``: brightness, contrast and saturation within 1e-6; the hue
  step byte for byte after ``* 255``, and its two conversions equal to
  ``cv2.cvtColor`` for every 8-bit input, in OpenCV's SIMD blocks and in a
  row's scalar tail.

Then each class built from its ``vsrd.transforms.<Name>`` config through the
port's registry, and ``jet_color`` against ``cv2.applyColorMap``.
"""

import cv2
import numpy as np
import pytest

from vsrd_tpu.data import transforms as jt
from vsrd_tpu_torch.configuration import registry
from vsrd_tpu_torch.data import transforms as tt
from vsrd_tpu_torch.tools.kitti_360 import visualize_predictions

H, W = 24, 37             # 37: one OpenCV SIMD block of 32 pixels and a tail of 5


def _sample(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    k = np.array([[30.0, 0.0, w / 2], [0.0, 30.0, h / 2], [0.0, 0.0, 1.0]])
    k += rng.normal(scale=0.1, size=(3, 3)) * [[1, 0, 1], [0, 1, 1], [0, 0, 0]]
    return {
        "image": rng.random((h, w, 3)).astype(np.float32),
        "masks": (rng.random((3, h, w)) > 0.6).astype(np.float32),
        "intrinsic_matrix": k,
        "crop_box": np.array([[3.0, 4.0], [20.0, 15.0]]),
        "image_size": (h, w),
    }


def _assert_same(got, want, atol=0.0, keys=None):
    for key in keys or want:
        if atol:
            np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


@pytest.mark.parametrize("position, size", [((2, 5), (16, 20)), ((10, 30), (20, 20))])
def test_cropper_matches_jax(position, size):
    sample = _sample(1)
    want = jt.Cropper(position, size)(sample)
    got = tt.Cropper(position, size)(sample)
    _assert_same(got, want, keys=("image", "masks", "intrinsic_matrix"))
    assert got["image_size"] == got["image"].shape[:2]


@pytest.mark.parametrize("size", [(16, 25), (40, 50)])
@pytest.mark.parametrize("image_mode, masks_mode", [("bilinear", "nearest"),
                                                    ("nearest", "bilinear"),
                                                    ("nearest", "nearest"),
                                                    ("bilinear", "bilinear")])
def test_resizer_modes_match_jax(image_mode, masks_mode, size):
    """Every interpolation mode of the JAX ``Resizer``, down and up: nearest
    results equal, bilinear ones within 1e-5 (``resize_linear``, as above)."""
    sample = _sample(2)
    want = jt.Resizer(size, image_mode, masks_mode)(sample)
    got = tt.Resizer(size, image_mode, masks_mode)(sample)
    for key, mode in (("image", image_mode), ("masks", masks_mode)):
        _assert_same(got, want, atol=1e-5 if mode == "bilinear" else 0.0, keys=(key,))
    _assert_same(got, want, keys=("intrinsic_matrix",))
    assert got["image_size"] == tuple(size)


@pytest.mark.parametrize("seed", range(4))
def test_random_horizontal_flipper_matches_jax(seed):
    jflip = jt.RandomHorizontalFlipper(0.5, rng=np.random.default_rng(seed))
    tflip = tt.RandomHorizontalFlipper(0.5, rng=np.random.default_rng(seed))
    flips = []
    for round_ in range(6):
        if round_:
            jflip.update_params()
            tflip.update_params()
        assert tflip.flip == jflip.flip
        flips.append(tflip.flip)
        sample = _sample(seed * 10 + round_)
        _assert_same(tflip(sample), jflip(sample), keys=("image", "masks", "intrinsic_matrix"))
        # without the image, the size comes from image_size
        bare = {k: v for k, v in sample.items() if k != "image"}
        np.testing.assert_array_equal(tflip(bare)["intrinsic_matrix"],
                                      jflip(sample)["intrinsic_matrix"])
    assert len(set(flips)) == 2 or seed, flips


def test_box_jitter_matches_jax():
    jitter_j = jt.BoxJitter((-0.1, 0.2), rng=np.random.default_rng(3))
    jitter_t = tt.BoxJitter((-0.1, 0.2), rng=np.random.default_rng(3))
    for seed in range(3):
        sample = _sample(seed)
        _assert_same(jitter_t(sample), jitter_j(sample), keys=("crop_box",))


FBM = dict(amplitude=0.3, resolution=(3, 5), persistence=0.5, lacunarity=2, num_octaves=3)


@pytest.mark.parametrize("size", [(H, W), (47, 64)])
def test_fractal_brownian_motion_matches_jax(size):
    sample = _sample(4, *size)
    want = jt.FractalBrownianMotion(**FBM, rng=np.random.default_rng(5))(sample)
    got = tt.FractalBrownianMotion(**FBM, rng=np.random.default_rng(5))(sample)
    _assert_same(got, want, atol=1e-6, keys=("image",))
    assert not np.array_equal(got["image"], sample["image"])


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_fast_fractal_brownian_motion_matches_jax(factor):
    sample = _sample(6, 48, 70)
    want = jt.FastFractalBrownianMotion(**FBM, downscale_factor=factor,
                                        rng=np.random.default_rng(7))(sample)
    got = tt.FastFractalBrownianMotion(**FBM, downscale_factor=factor,
                                       rng=np.random.default_rng(7))(sample)
    _assert_same(got, want, atol=1e-5, keys=("image",))


@pytest.mark.parametrize("kernel_size", [3, 5, 7])
def test_random_convolution_matches_jax(kernel_size):
    for seed in range(3):
        sample = _sample(8 + seed)
        want = jt.RandomConvolution([kernel_size], rng=np.random.default_rng(seed))(sample)
        got = tt.RandomConvolution([kernel_size], rng=np.random.default_rng(seed))(sample)
        _assert_same(got, want, atol=1e-5, keys=("image",))


@pytest.mark.parametrize("kernel_size", [3, 4, 7])
def test_filter2d_matches_opencv(kernel_size):
    rng = np.random.default_rng(kernel_size)
    image = rng.random((19, 23, 3)).astype(np.float32)
    kernel = rng.normal(size=(kernel_size, kernel_size)).astype(np.float32)
    np.testing.assert_allclose(tt.filter2d(image, kernel), cv2.filter2D(image, -1, kernel),
                               atol=1e-5, rtol=0)
    assert tt.filter2d(image, kernel).dtype == np.float32


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_matches_jax(seed):
    ranges = dict(brightness=(0.6, 1.4), contrast=(0.6, 1.4), saturation=(0.6, 1.4),
                  hue=(-0.3, 0.3))
    jitter_j = jt.ColorJitter(**ranges, rng=np.random.default_rng(seed))
    jitter_t = tt.ColorJitter(**ranges, rng=np.random.default_rng(seed))
    for round_ in range(3):
        if round_:
            jitter_j.update_params()
            jitter_t.update_params()
        assert jitter_t.factors == jitter_j.factors
        np.testing.assert_array_equal(jitter_t.order, jitter_j.order)
        sample = _sample(seed * 3 + round_)
        for name in ("brightness", "contrast", "saturation"):
            np.testing.assert_allclose(jitter_t._apply(sample["image"], name),
                                       jitter_j._apply(sample["image"], name), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(jitter_t._apply(sample["image"], "hue") * 255,
                                      jitter_j._apply(sample["image"], "hue") * 255)
        want = jitter_j(sample)["augmented_image"]
        got = jitter_t(sample)["augmented_image"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hue", [0.0, 0.1, 0.5, 0.97, -0.4])
def test_color_jitter_hue_is_opencvs(hue):
    """The hue step alone on grey pixels, the primaries and secondaries, and
    random ones, with shifts that wrap at 180: equal to the JAX class (cv2)
    after * 255."""
    rng = np.random.default_rng(int(hue * 100) + 50)
    special = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [0.2, 0.2, 0.2],
                        [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                        [0.9, 0.1, 0.1], [0.1, 0.1, 0.9]], np.float32)
    image = rng.random((5, 45, 3)).astype(np.float32)
    image.reshape(-1, 3)[:len(special)] = special
    image.reshape(-1, 3)[-len(special):] = special       # in the scalar tail too
    jitter_j = jt.ColorJitter(hue=(hue, hue), rng=np.random.default_rng(0))
    jitter_t = tt.ColorJitter(hue=(hue, hue), rng=np.random.default_rng(0))
    np.testing.assert_array_equal(jitter_t._apply(image, "hue") * 255,
                                  jitter_j._apply(image, "hue") * 255)


def test_hsv_conversions_equal_opencv_for_every_input():
    """rgb_to_hsv over all 2^24 RGB triplets and hsv_to_rgb over all 180 x
    256 x 256 HSV ones, in rows of 256 (OpenCV's SIMD blocks) and in rows of
    one pixel (its scalar path)."""
    levels = np.arange(256, dtype=np.uint8)
    b, c = np.meshgrid(levels, levels, indexing="ij")
    for first in range(256):
        rgb = np.stack([np.full_like(b, first), b, c], axis=-1)
        want = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
        np.testing.assert_array_equal(tt.rgb_to_hsv(rgb), want)
        if first % 15 == 0:
            np.testing.assert_array_equal(tt.rgb_to_hsv(rgb.reshape(-1, 1, 3)),
                                          want.reshape(-1, 1, 3))
    for first in range(180):
        hsv = np.stack([np.full_like(b, first), b, c], axis=-1)
        np.testing.assert_array_equal(tt.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
        column = hsv.reshape(-1, 1, 3)
        np.testing.assert_array_equal(tt.hsv_to_rgb(column),
                                      cv2.cvtColor(column, cv2.COLOR_HSV2RGB))


CONFIGS = {
    "Cropper": dict(position=[2, 3], image_size=[16, 20]),
    "RandomHorizontalFlipper": dict(probability=1.0),
    "BoxJitter": dict(scale_range=[-0.1, 0.1]),
    "FractalBrownianMotion": FBM,
    "FastFractalBrownianMotion": dict(FBM, downscale_factor=2),
    "RandomConvolution": dict(kernel_sizes=[3, 5]),
    "ColorJitter": dict(brightness=[0.8, 1.2], hue=[-0.1, 0.1]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_augmentations_build_from_their_configs(name):
    built = registry.instantiate({"function": f"vsrd.transforms.{name}", "kwargs": CONFIGS[name]})
    assert type(built) is getattr(tt, name)
    out = built(_sample(9))
    assert set(out) >= set(_sample(9)) - {"image"}


def test_register_adds_constructors():
    @registry.register("test.augmentation")
    def make(value):
        return value * 2

    @registry.register
    def make_default():
        return 1

    default_name = "test_register_adds_constructors.<locals>.make_default"
    assert registry.instantiate({"function": "test.augmentation", "args": [3]}) == 6
    assert registry.REGISTRY[default_name] is make_default
    del registry.REGISTRY["test.augmentation"]
    del registry.REGISTRY[default_name]


def test_jet_color_matches_opencv():
    values = np.arange(256, dtype=np.uint8)
    want = cv2.applyColorMap(values[:, None], cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(visualize_predictions.JET_LUT, want)
    for value in values:
        assert visualize_predictions.jet_color(value / 255.0) == tuple(
            int(c) for c in want[int(value / 255.0 * 255)])
