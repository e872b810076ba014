"""PNG decoding and encoding without PIL or cv2.

Reads 8-bit, non-interlaced greyscale, greyscale + alpha, RGB and RGBA PNGs
as ``PIL.Image.open`` + ``np.asarray`` give them (``[H, W]`` for grey, else
``[H, W, C]``, uint8; ``read_rgb`` as ``.convert("RGB")`` gives them, for
the detector leg and the visualizers), and 16-bit greyscale ones (the
instance maps) as ``cv2.imread(..., IMREAD_ANYDEPTH)`` gives them: the IDAT
chunks are inflated with the standard library's ``zlib``, then the five
scanline filters are reversed by ``png_filters.cpp``, compiled with g++ on
first use into the port's build directory as ``data/native.py`` compiles
its source. ``write_png`` writes 8-bit grey and RGB and 16-bit grey.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # color type -> samples per pixel
_LOCK = threading.Lock()
_LIB = None


def _load():
    """The compiled ``png_unfilter``; raises ``RuntimeError`` with the
    compiler's output where ``png_filters.cpp`` cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                lib = native.build_and_load(Path(__file__).with_name("png_filters.cpp"),
                                            "vsrd_png")
            except (OSError, subprocess.SubprocessError) as error:
                raise RuntimeError("data/png_filters.cpp could not be built: "
                                   f"{native.describe(error)}") from error
            i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
            lib.png_unfilter.restype = i64
            _LIB = lib
        return _LIB


def unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the scanline filters of ``height`` inflated rows of ``stride``
    bytes (each after its filter byte): ``[height, stride]`` uint8."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    lib = _load()
    raw = np.ascontiguousarray(raw)
    out = np.empty((height, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.png_unfilter(raw.ctypes.data_as(u8p), height, stride, bpp, out.ctypes.data_as(u8p))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def _chunks(filename: str):
    """The IHDR fields and the inflated image data of a PNG file."""
    with open(filename, "rb") as file:
        blob = file.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{filename} is not a PNG file")
    offset, header, idat = 8, None, []
    while offset + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[offset:offset + 8])
        body = blob[offset + 8:offset + 8 + length]
        offset += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{filename} has no IHDR chunk")
    return header, zlib.decompress(b"".join(idat))


def read_png(filename: str) -> np.ndarray:
    """The pixels of an 8-bit non-interlaced PNG, uint8, shaped as PIL
    gives them."""
    (width, height, depth, color, _, _, interlace), data = _chunks(filename)
    if depth != 8 or color not in CHANNELS or interlace != 0:
        raise ValueError(f"{filename}: only 8-bit non-interlaced grey, grey+alpha, RGB and "
                         f"RGBA PNGs are read (bit depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    channels = CHANNELS[color]
    pixels = unfilter(data, height, width * channels, channels)
    return pixels.reshape(height, width) if channels == 1 else pixels.reshape(
        height, width, channels)


def read_png_anydepth(filename: str) -> np.ndarray:
    """A greyscale PNG as ``cv2.imread(filename, cv2.IMREAD_ANYDEPTH)`` gives
    it: ``[H, W]`` uint16 for 16 bits a sample (KITTI-360's instance maps,
    big-endian samples whose filters run over byte pairs), uint8 for 8 bits,
    as ``read_png`` reads it."""
    (width, height, depth, color, _, _, interlace), data = _chunks(filename)
    if color != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"{filename}: only 8- and 16-bit non-interlaced greyscale PNGs are "
                         f"read at any depth (bit depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    if depth == 8:
        return read_png(filename)
    pixels = unfilter(data, height, width * 2, 2)
    return pixels.view(">u2").reshape(height, width).astype(np.uint16)


def write_png(filename: str, pixels: np.ndarray) -> None:
    """Write ``pixels`` as a non-interlaced PNG, ``read_png``'s and
    ``read_png_anydepth``'s inverse: ``[H, W]`` uint8 as 8-bit grey, ``[H, W,
    3]`` uint8 as 8-bit RGB, ``[H, W]`` uint16 as 16-bit grey (big-endian).
    Every row is filtered by Up, and the image data is deflated by zlib."""
    pixels = np.asarray(pixels)
    if pixels.dtype == np.uint8 and pixels.ndim == 2:
        depth, color, flat = 8, 0, pixels
    elif pixels.dtype == np.uint8 and pixels.ndim == 3 and pixels.shape[2] == 3:
        depth, color, flat = 8, 2, pixels.reshape(pixels.shape[0], -1)
    elif pixels.dtype == np.uint16 and pixels.ndim == 2:
        depth, color, flat = 16, 0, pixels.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"write_png takes [H, W] uint8 or uint16 or [H, W, 3] uint8, not "
                         f"{pixels.shape} {pixels.dtype}")
    height, width = pixels.shape[:2]
    rows = flat.copy()
    rows[1:] -= flat[:-1]                                # Up: uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), rows], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    with open(filename, "wb") as file:
        file.write(SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
                   + chunk(b"IEND", b""))


def read_rgb(filename: str) -> np.ndarray:
    """A PNG as ``Image.open(filename).convert("RGB")`` gives it: ``[H, W,
    3]`` uint8, grey replicated into the three channels, alpha dropped."""
    pixels = read_png(filename)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    if pixels.shape[-1] <= 2:                     # grey, grey + alpha
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def read_image(filename: str) -> np.ndarray:
    """A PNG as float32 in [0, 1], as the JAX package reads it
    (``np.asarray(Image.open(filename)) / 255``)."""
    return read_png(filename).astype(np.float32) / 255.0
