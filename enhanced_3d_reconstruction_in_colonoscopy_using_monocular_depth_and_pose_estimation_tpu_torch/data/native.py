"""ctypes bindings for the native PNG and TIFF readers.

The port's counterpart of the JAX package's ``data/native``: the C++
sources are the port's own copies (``csrc/host/pngdec.cpp``, which links
zlib, and ``csrc/host/tiffdec.cpp``), built by the port's
``utils/cbuild.py`` into ``build/host/`` at first use, never at import.

- PNG: non-interlaced 8-bit gray, gray+alpha, RGB, RGBA and 16-bit gray
  and RGB, decoded a batch at a time on C++ threads into one contiguous
  buffer;
- TIFF: baseline striped 8/16-bit, uncompressed, LZW or PackBits, with
  the horizontal-differencing predictor (the C3VD depth format).

Anything else raises ``ValueError``: the port has no PIL or cv2 to fall
back to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import cbuild

_PNG_LIB = None
_TIFF_LIB = None


def _png_lib():
    global _PNG_LIB
    if _PNG_LIB is None:
        lib = cbuild.load("host/pngdec")
        lib.e3d_png_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.e3d_png_info.restype = ctypes.c_int
        lib.e3d_png_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
        lib.e3d_png_decode_batch.restype = ctypes.c_int
        _PNG_LIB = lib
    return _PNG_LIB


def _tiff_lib():
    global _TIFF_LIB
    if _TIFF_LIB is None:
        lib = cbuild.load("host/tiffdec")
        lib.e3d_tiff_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.e3d_tiff_info.restype = ctypes.c_int
        lib.e3d_tiff_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong]
        lib.e3d_tiff_decode.restype = ctypes.c_int
        _TIFF_LIB = lib
    return _TIFF_LIB


def png_info(path: str) -> tuple[int, int, int, int]:
    """(height, width, channels, bit_depth) of a PNG the reader takes;
    ``ValueError`` for any other file (palette, interlaced, 1/2/4-bit)."""
    w, h, c, b = (ctypes.c_int() for _ in range(4))
    rc = _png_lib().e3d_png_info(path.encode(), ctypes.byref(w),
                                 ctypes.byref(h), ctypes.byref(c),
                                 ctypes.byref(b))
    if rc != 0:
        raise ValueError(f"unsupported or unreadable PNG: {path}")
    return h.value, w.value, c.value, b.value


def decode_png_batch(paths: list[str], num_threads: int = 4) -> np.ndarray:
    """Decode same-shape PNGs into one contiguous (N, H, W, C) array
    (uint8 or uint16; (N, H, W) for one channel). Raises on any failure."""
    if not paths:
        raise ValueError("empty path list")
    h, w, c, bits = png_info(paths[0])
    out = np.empty((len(paths), h, w, c),
                   np.uint16 if bits == 16 else np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failures = _png_lib().e3d_png_decode_batch(
        arr, len(paths), h, w, c, bits,
        out.ctypes.data_as(ctypes.c_void_p), num_threads)
    if failures:
        raise ValueError(f"{failures} PNG(s) failed to decode "
                         f"(truncated, or shape/format mismatch)")
    return out[..., 0] if c == 1 else out


def tiff_info(path: str) -> tuple[int, int, int, int]:
    """(height, width, channels, bit_depth) of a baseline striped TIFF."""
    h, w, c, b = (ctypes.c_int() for _ in range(4))
    rc = _tiff_lib().e3d_tiff_info(path.encode(), ctypes.byref(h),
                                   ctypes.byref(w), ctypes.byref(c),
                                   ctypes.byref(b))
    if rc != 0:
        raise ValueError(f"unsupported or unreadable TIFF ({rc}): {path}")
    return h.value, w.value, c.value, b.value


def decode_tiff(path: str) -> np.ndarray:
    """Decode a striped 8/16-bit TIFF -> (H, W) or (H, W, C) array."""
    h, w, c, bits = tiff_info(path)
    out = np.empty((h, w, c), np.uint16 if bits == 16 else np.uint8)
    rc = _tiff_lib().e3d_tiff_decode(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise ValueError(f"TIFF decode failed ({rc}): {path}")
    return out[..., 0] if c == 1 else out
