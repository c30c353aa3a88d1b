"""ctypes shim over the native runtime (native/tgtc_runtime.cpp).

The port's own copy of tgtc/utils/native.py: it compiles the same C++
source with ``g++`` on first use, into ``tgtc_torch/_build/`` keyed by a
hash of the source, and keeps the reference's PIL/numpy path for hosts
without a toolchain (this is host-side image IO, not a device kernel).

Use :func:`write_png_async` in artifact-heavy loops and :func:`wait_writes`
before relying on the files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "tgtc_runtime.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libtgtc_runtime-{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp), "-lz", "-pthread"],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tgtc_write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
        lib.tgtc_write_png.restype = ctypes.c_int
        lib.tgtc_write_png_async.argtypes = lib.tgtc_write_png.argtypes
        lib.tgtc_write_png_async.restype = None
        lib.tgtc_wait_writes.argtypes = []
        lib.tgtc_wait_writes.restype = ctypes.c_long
        lib.tgtc_resize_box.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, u8p]
        lib.tgtc_resize_box.restype = None
        _lib = lib
        return _lib


def _as_u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_png(path: str, img: np.ndarray) -> None:
    """Synchronous PNG write (native if available, PIL otherwise)."""
    img = _as_u8(img)
    lib = get_lib()
    if lib is not None and img.ndim == 3 and img.shape[2] in (1, 3, 4):
        h, w, c = img.shape
        if lib.tgtc_write_png(path.encode(), _u8p(img), h, w, c) == 0:
            return
    from PIL import Image

    Image.fromarray(img.squeeze() if img.ndim == 3 and img.shape[2] == 1
                    else img).save(path)


def write_png_async(path: str, img: np.ndarray) -> None:
    """Queue a PNG write on the native thread pool (falls back to sync).
    The native side copies the pixels before this returns."""
    img = _as_u8(img)
    lib = get_lib()
    if lib is not None and img.ndim == 3 and img.shape[2] in (1, 3, 4):
        h, w, c = img.shape
        lib.tgtc_write_png_async(path.encode(), _u8p(img), h, w, c)
        return
    write_png(path, img)


def wait_writes() -> int:
    """Block until queued async writes finish; returns the error count."""
    lib = get_lib()
    if lib is None:
        return 0
    return int(lib.tgtc_wait_writes())


def resize_box(img: np.ndarray, factor: int) -> np.ndarray:
    """Area-average downsample by an integer factor (native or numpy)."""
    img = _as_u8(img)
    h, w, c = img.shape
    dh, dw = h // factor, w // factor
    lib = get_lib()
    if lib is not None:
        out = np.empty((dh, dw, c), np.uint8)
        lib.tgtc_resize_box(_u8p(img), h, w, c, factor, _u8p(out))
        return out
    trimmed = img[: dh * factor, : dw * factor]
    return (trimmed.reshape(dh, factor, dw, factor, c)
            .mean(axis=(1, 3)).astype(np.uint8))
