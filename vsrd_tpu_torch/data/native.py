"""ctypes loader for the native data-path kernels (``native/vsrd_native.cpp``).

Counterpart of ``vsrd_tpu/data/native.py``: COCO RLE decode and encode and
the SoftRasterizer's polygon distance map in C++, for the host input
pipeline. The source is the repository's ``native/vsrd_native.cpp``; it is
compiled with g++ on first use into the port's build directory
(``rendering.field_kernels.build_dir()``, git-ignored), under a name that
carries a hash of the source, never next to the source. Every entry point
returns ``None`` when the library cannot be built or loaded, and its caller
then takes the numpy version, which gives the same result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
build_error: str | None = None


def source_path() -> Path:
    return Path(__file__).resolve().parents[2] / "native" / "vsrd_native.cpp"


def _build(source: Path, target: Path) -> None:
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", str(tmp),
                        str(source)], check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def build_and_load(source: Path, stem: str) -> ctypes.CDLL:
    """Compile the host C++ ``source`` with g++ into the port's build
    directory as ``lib<stem>_<hash of the source>.so`` (once per source
    content) and load it. Raises ``OSError`` or ``SubprocessError``."""
    from ..rendering.field_kernels import build_dir

    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"lib{stem}_{digest}.so"
    if not target.exists():
        _build(source, target)
    return ctypes.CDLL(str(target))


def describe(error: Exception) -> str:
    """A build or load failure, with the compiler's output."""
    detail = getattr(error, "stderr", "") or ""
    return f"{type(error).__name__}: {error} {detail}".strip()


def load():
    """The loaded library, or None (the numpy versions are used); the reason
    a build or load failed is kept in ``build_error``."""
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = build_and_load(source_path(), "vsrd_native")
        except (OSError, subprocess.SubprocessError) as error:
            build_error = describe(error)
            return None

        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        lib.rle_decode.argtypes = [ctypes.POINTER(i64), i64, i64, i64, ctypes.c_char_p]
        lib.rle_decode.restype = None
        lib.rle_encode.argtypes = [ctypes.c_char_p, i64, i64, ctypes.POINTER(i64), i64]
        lib.rle_encode.restype = i64
        lib.polygon_distance_map.argtypes = [f32p, i64, i64, i64, f32p]
        lib.polygon_distance_map.restype = None
        _LIB = lib
        return _LIB


def rle_decode_native(counts, size):
    lib = load()
    if lib is None:
        return None
    h, w = int(size[0]), int(size[1])
    counts_arr = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(counts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(counts_arr),
                   h, w, out.ctypes.data_as(ctypes.c_char_p))
    return out


def rle_encode_native(mask):
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    max_counts = h * w + 2
    counts = np.zeros(max_counts, np.int64)
    num = lib.rle_encode(mask.ctypes.data_as(ctypes.c_char_p), h, w,
                         counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_counts)
    if num < 0:
        return None
    return counts[:num].tolist()


def polygon_distance_map_native(polygon, image_size):
    lib = load()
    if lib is None:
        return None
    polygon = np.ascontiguousarray(polygon, dtype=np.float32)
    h, w = int(image_size[0]), int(image_size[1])
    out = np.zeros((h, w), np.float32)
    lib.polygon_distance_map(polygon.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             len(polygon), h, w,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
