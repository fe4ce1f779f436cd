"""ctypes bindings for the native media codecs (JPEG + AVI/MP4 containers).

The port's counterpart of the JAX package's ``media/native``: the C++
sources are the port's own copies (``csrc/host/jpegcodec.cpp``,
``csrc/host/container.cpp``), built by the port's ``utils/cbuild.py``
into ``build/host/`` at first use. MJPEG streams are demuxed, decoded,
encoded and remuxed natively; ``media/video.py`` refuses other codecs.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import cbuild

_JPEG_LIB = None


def _jpeg_lib():
    global _JPEG_LIB
    if _JPEG_LIB is None:
        lib = cbuild.load("host/jpegcodec")
        lib.e3d_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.e3d_jpeg_info.restype = ctypes.c_int
        lib.e3d_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        lib.e3d_jpeg_decode.restype = ctypes.c_int
        lib.e3d_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
        lib.e3d_jpeg_encode.restype = ctypes.c_long
        _JPEG_LIB = lib
    return _JPEG_LIB


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(height, width, channels) of a JPEG byte stream."""
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = _jpeg_lib().e3d_jpeg_info(data, len(data), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"unsupported JPEG ({rc})")
    return h.value, w.value, c.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode baseline JPEG bytes -> (H, W) gray or (H, W, 3) RGB uint8.

    Raises ValueError on progressive/arithmetic/12-bit streams."""
    h, w, c = jpeg_info(data)
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    rc = _jpeg_lib().e3d_jpeg_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise ValueError(f"JPEG decode failed ({rc})")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """Encode (H, W) gray or (H, W, 3) RGB uint8 as baseline JFIF (4:2:0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        h, w, c = *img.shape, 1
    elif img.ndim == 3 and img.shape[2] in (1, 3):
        h, w, c = img.shape
    else:
        raise ValueError(f"expected (H,W) or (H,W,{{1,3}}), got {img.shape}")
    # High-entropy content can exceed 1 B/px entropy-coded (worst-case
    # baseline JPEG is a few B/px with byte stuffing): grow on the
    # buffer-too-small rc instead of failing a legitimate encode.
    cap = img.nbytes + (1 << 16)
    for _ in range(4):
        out = ctypes.create_string_buffer(cap)
        n = _jpeg_lib().e3d_jpeg_encode(
            img.ctypes.data_as(ctypes.c_void_p), h, w, c, int(quality),
            out, cap)
        if n >= 0:
            return out.raw[:n]
        if n != -2:  # not "output buffer full"
            break
        cap *= 4
    raise ValueError(f"JPEG encode failed ({n})")


# ----------------------------- containers -----------------------------------

_CONT_LIB = None


def _cont_lib():
    global _CONT_LIB
    if _CONT_LIB is None:
        lib = cbuild.load("host/container")
        lib.e3d_video_open.argtypes = [ctypes.c_char_p]
        lib.e3d_video_open.restype = ctypes.c_void_p
        lib.e3d_video_info.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int)] * 6 + [ctypes.c_char_p]
        lib.e3d_video_info.restype = ctypes.c_int
        lib.e3d_video_frame_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.e3d_video_frame_size.restype = ctypes.c_long
        lib.e3d_video_frame.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_long]
        lib.e3d_video_frame.restype = ctypes.c_int
        lib.e3d_video_close.argtypes = [ctypes.c_void_p]
        lib.e3d_video_close.restype = None
        for pre in ("avi", "mp4"):
            open_ = getattr(lib, f"e3d_{pre}_writer_open")
            open_.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
            open_.restype = ctypes.c_void_p
            fr = getattr(lib, f"e3d_{pre}_writer_frame")
            fr.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
            fr.restype = ctypes.c_int
            cl = getattr(lib, f"e3d_{pre}_writer_close")
            cl.argtypes = [ctypes.c_void_p]
            cl.restype = ctypes.c_int
        _CONT_LIB = lib
    return _CONT_LIB


class VideoReader:
    """Sample-level reader for AVI and MP4 containers (any codec; decode
    to pixels only possible for MJPEG payloads via :func:`decode_jpeg`).

    Index is built with seeks only; frames are fetched on demand, so
    multi-GB recordings are never resident."""

    def __init__(self, path: str):
        self._h = _cont_lib().e3d_video_open(os.fsencode(path))
        if not self._h:
            raise ValueError(f"unsupported or unreadable container: {path}")
        vals = [ctypes.c_int() for _ in range(6)]
        fourcc = ctypes.create_string_buffer(5)
        rc = _cont_lib().e3d_video_info(self._h, *map(ctypes.byref, vals),
                                        fourcc)
        if rc != 0:
            self.close()
            raise ValueError(f"container info failed ({rc}): {path}")
        self.width, self.height, self.num_frames = (v.value for v in vals[:3])
        self.fps = vals[3].value / max(vals[4].value, 1)
        self.is_mjpeg = bool(vals[5].value)
        self.fourcc = fourcc.value.decode("latin-1")

    def frame_bytes(self, idx: int) -> bytes:
        """Raw codec sample (a full JPEG for MJPEG streams)."""
        n = _cont_lib().e3d_video_frame_size(self._h, idx)
        if n < 0:
            raise IndexError(idx)
        buf = ctypes.create_string_buffer(int(n))
        rc = _cont_lib().e3d_video_frame(self._h, idx, buf, n)
        if rc != 0:
            raise ValueError(f"frame read failed ({rc}) at {idx}")
        return buf.raw

    def frame_rgb(self, idx: int) -> np.ndarray:
        """Decode frame idx to (H, W, 3) RGB (MJPEG streams only)."""
        if not self.is_mjpeg:
            raise ValueError(f"stream codec {self.fourcc!r} is not MJPEG")
        img = decode_jpeg(self.frame_bytes(idx))
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return img

    def close(self):
        if self._h:
            _cont_lib().e3d_video_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _Writer:
    """MJPEG writer over an AVI or MP4 container ('avi' / 'mp4')."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0, container: str = "avi"):
        if container not in ("avi", "mp4"):
            raise ValueError(container)
        num, den = _fps_to_ratio(fps)
        self._lib = _cont_lib()
        self._close = getattr(self._lib, f"e3d_{container}_writer_close")
        self._frame = getattr(self._lib, f"e3d_{container}_writer_frame")
        self._h = getattr(self._lib, f"e3d_{container}_writer_open")(
            os.fsencode(path), width, height, num, den)
        if not self._h:
            raise OSError(f"cannot open for writing: {path}")

    def write_jpeg(self, data: bytes):
        rc = self._frame(self._h, data, len(data))
        if rc == -2:
            raise OSError("frame would exceed the 4 GiB classic-RIFF "
                          "limit; write MP4 (64-bit offsets) instead")
        if rc != 0:
            raise OSError(f"frame write failed ({rc}): disk full/IO error")

    def write_rgb(self, img: np.ndarray, quality: int = 90):
        self.write_jpeg(encode_jpeg(img, quality))

    def close(self):
        if self._h:
            rc = self._close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"container finalize failed ({rc}); "
                              "output file is incomplete")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def VideoWriter(path: str, width: int, height: int, fps: float = 30.0,
                container: str | None = None) -> _Writer:
    """MJPEG video writer; container inferred from the extension unless
    given explicitly."""
    if container is None:
        container = "mp4" if path.lower().endswith(".mp4") else "avi"
    return _Writer(path, width, height, fps, container)


def _fps_to_ratio(fps: float) -> tuple[int, int]:
    """Rational fps: exact for integers and the NTSC 29.97/23.976 family."""
    if abs(fps - round(fps)) < 1e-6:
        return int(round(fps)), 1
    num = int(round(fps * 1001))
    if abs(num / 1001 - fps) < 1e-6:
        return num, 1001
    return int(round(fps * 1000)), 1000
