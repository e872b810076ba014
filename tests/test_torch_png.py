"""The port's PNG decoding and bilinear resize against PIL and OpenCV, and
the labeling driver's photometric run, which reads pixels through them.

PNGs with every scanline filter (None, Sub, Up, Average, Paeth, and a mix
by row) in every 8-bit colour type are written here with zlib, then decoded
by PIL and by the port (its compiled unfilter and its Python loop): equal
byte for byte; 16-bit grey ones likewise against cv2's IMREAD_ANYDEPTH, and
the port's writer is read back by cv2. The resize is held to ``cv2.resize(INTER_LINEAR)`` on float
images within 2e-7 (2 ulp at 1.0: OpenCV's SIMD rows round a product or a
sum differently); at KITTI-360's native size it is the identity.
"""

import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from vsrd_tpu_torch.data import kitti360 as tk, png, transforms
from vsrd_tpu_torch.pipeline import frame as tfm
from vsrd_tpu_torch.scripts import main as tmain

import test_torch_driver as drv

COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG colour type


def _filter_row(row, prev, bpp, kind):
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((row - pred) & 0xFF).astype(np.uint8)


def _write_png(path, pixels, filters):
    """An 8-bit PNG of ``pixels`` [H, W(, C)] (a 16-bit grey one of uint16
    ``pixels`` [H, W], big-endian byte pairs), row y filtered with
    ``filters[y % len(filters)]``, its image data in two IDAT chunks."""
    h, w = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    depth = 16 if pixels.dtype == np.uint16 else 8
    bpp = channels * depth // 8
    flat = (pixels.astype(">u2").view(np.uint8) if depth == 16 else pixels).reshape(h, w * bpp)
    prev = np.zeros(w * bpp, np.uint8)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        raw.append(kind)
        raw += _filter_row(flat[y], prev, bpp, kind).tobytes()
        prev = flat[y]
    data = zlib.compress(bytes(raw), 6)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPES[channels], 0, 0, 0)
    half = len(data) // 2
    with open(path, "wb") as file:
        file.write(png.SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", data[:half])
                   + chunk(b"IDAT", data[half:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 0, 2, 1)])
def test_png_decoder_matches_pil(tmp_path, channels, filters):
    rng = np.random.default_rng(channels * 10 + len(filters))
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    # smooth ramps plus noise, so that the predictors are exercised both ways
    base = (np.arange(23)[:, None] * 7 + np.arange(37)[None, :] * 3)
    if channels > 1:
        base = base[..., None] + np.arange(channels) * 40
    pixels = ((base + rng.integers(0, 60, shape)) % 256).astype(np.uint8)
    path = str(tmp_path / "image.png")
    _write_png(path, pixels, filters)
    expected = np.asarray(Image.open(path))
    np.testing.assert_array_equal(expected, pixels)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)
    if channels == 3:
        np.testing.assert_array_equal(png.read_image(path),
                                      expected.astype(np.float32) / 255.0)


def test_png_decoder_reads_pil_and_opencv_files_and_refuses_others(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    Image.fromarray(image).save(tmp_path / "pil.png")
    cv2.imwrite(str(tmp_path / "cv2.png"), image)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "pil.png")), image)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "cv2.png")), image[..., ::-1])
    Image.fromarray((rng.integers(0, 65535, (8, 8))).astype(np.uint16)).save(tmp_path / "16.png")
    with pytest.raises(ValueError, match="8-bit"):
        png.read_png(str(tmp_path / "16.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "not.png"))


def _instance_map(seed, shape=(23, 37)):
    """A uint16 map of KITTI-360 instance ids (26000 + i, values far above
    255, so that both bytes of a sample vary) over ramps and noise."""
    rng = np.random.default_rng(seed)
    ramp = np.arange(shape[0])[:, None] * 301 + np.arange(shape[1])[None, :] * 257
    return (26000 + ramp + rng.integers(0, 600, shape)).astype(np.uint16)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 0, 2, 1)])
def test_png_16bit_read_matches_opencv(tmp_path, filters):
    """16-bit grey PNGs filtered by each filter (Paeth over byte pairs
    included), by cv2 and by write_png: read_png_anydepth equals
    cv2.imread(IMREAD_ANYDEPTH) value for value."""
    pixels = _instance_map(len(filters) * 7 + filters[0])
    paths = {name: str(tmp_path / f"{name}.png") for name in ("filtered", "cv2", "port")}
    _write_png(paths["filtered"], pixels, filters)
    cv2.imwrite(paths["cv2"], pixels)
    png.write_png(paths["port"], pixels)
    for path in paths.values():
        want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        assert want.dtype == np.uint16
        np.testing.assert_array_equal(want, pixels)
        got = png.read_png_anydepth(path)
        assert got.dtype == np.uint16 and got.shape == pixels.shape
        np.testing.assert_array_equal(got, want)


def test_png_writer_round_trips_through_opencv(tmp_path):
    """write_png's 8-bit grey and RGB files read back by cv2 pixel for pixel
    (RGB as cv2's BGR), and by the port's readers; 8-bit grey at any depth
    as cv2 reads it; other arrays refused."""
    rng = np.random.default_rng(3)
    grey = rng.integers(0, 256, (29, 41), dtype=np.uint8)
    rgb = rng.integers(0, 256, (29, 41, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "grey.png"), grey)
    png.write_png(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "grey.png"), cv2.IMREAD_UNCHANGED),
                                  grey)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png")), rgb[..., ::-1])
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "grey.png")), grey)
    np.testing.assert_array_equal(png.read_rgb(str(tmp_path / "rgb.png")), rgb)
    any_depth = png.read_png_anydepth(str(tmp_path / "grey.png"))
    assert any_depth.dtype == np.uint8
    np.testing.assert_array_equal(
        any_depth, cv2.imread(str(tmp_path / "grey.png"), cv2.IMREAD_ANYDEPTH))
    with pytest.raises(ValueError, match="greyscale"):
        png.read_png_anydepth(str(tmp_path / "rgb.png"))
    with pytest.raises(ValueError, match="write_png takes"):
        png.write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))


@pytest.mark.parametrize("src, dst", [((37, 53), (20, 31)), ((20, 31), (37, 53)),
                                      ((376, 1408), (188, 704)), ((375, 1242), (376, 1408)),
                                      ((10, 12), (7, 30)), ((40, 60), (40, 60))])
def test_linear_resize_matches_opencv(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for shape in (src, (*src, 3)):
        image = rng.random(shape).astype(np.float32)
        got = transforms.resize_linear(image, dst)
        want = cv2.resize(image, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
        if src == dst:
            np.testing.assert_array_equal(got, image)


def test_resizer_resizes_the_image_with_the_masks():
    rng = np.random.default_rng(1)
    sample = dict(image=rng.random((20, 30, 3)).astype(np.float32), image_size=(20, 30),
                  masks=(rng.random((2, 20, 30)) > 0.5).astype(np.float32),
                  intrinsic_matrix=np.eye(3, dtype=np.float32))
    out = transforms.Resizer((10, 15))(sample)
    assert out["image"].shape == (10, 15, 3) and out["masks"].shape == (2, 10, 15)
    np.testing.assert_allclose(out["image"], cv2.resize(sample["image"], (15, 10)), atol=2e-7)


def test_driver_reads_pixels_only_for_the_photometric_branch(tmp_path, monkeypatch):
    """The driver passes images to the frame build only with a positive
    photometric weight, decoded from the tree's PNGs; the run then takes
    the branch and finishes its frames."""
    import test_tools_e2e as e2e

    root = str(tmp_path)
    e2e._make_synthetic_kitti360(root)
    image_dir = os.path.join(root, "data_2d_raw", e2e.SEQUENCE, "image_00", "data_rect")
    split = os.path.join(root, "filenames", drv.SPLIT, e2e.SEQUENCE)
    os.makedirs(split)
    with open(os.path.join(split, "sampled_image_filenames.txt"), "w") as file:
        file.write(f"26000,26001 {os.path.join(image_dir, f'{2:010d}.png')} -1,1\n")
    built = []
    build = tfm.build_frame_data

    def spy(images, *args, **kwargs):
        built.append(images)
        return build(images, *args, **kwargs)

    monkeypatch.setattr(tfm, "build_frame_data", spy)
    for name, weight in (("plain", 0.0), ("photometric", 0.5)):
        config = drv._write_config(root, name, 1)
        with open(config) as file:
            data = json.load(file)
        data["loss_weights"] = {"photometric_loss": weight}
        data["surface_rendering"] = {"num_rays": 8, "num_iterations": 16}
        with open(config, "w") as file:
            json.dump(data, file)
        tmain.main(["--config", config, "--train", "--device", "cpu"])
        assert len(drv._checkpoints(root, name, drv.STEPS - 1)) == 1
    assert built[0] is None
    images = built[1]
    assert len(images) == 3 and images[0].shape == (e2e.H, e2e.W, 3)
    target = np.asarray(Image.open(os.path.join(image_dir, f"{2:010d}.png")))
    np.testing.assert_array_equal(images[1], target.astype(np.float32) / 255.0)
    dataset = tk.KITTI360Dataset(filenames=[os.path.join(split, "sampled_image_filenames.txt")])
    assert "image" not in dataset[0][0]
