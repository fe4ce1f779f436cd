"""PNG and 16-bit TIFF writers in pure Python (``zlib``, ``struct``,
``binascii.crc32``).

The JAX package writes its outputs and fixtures with ``cv2.imwrite`` and
PIL; the port has neither, so it writes the few formats it needs itself:

- ``write_png``: 8-bit gray (H, W), 8-bit RGB (H, W, 3) (given as BGR
  with ``bgr=True``, cv2's order) and 16-bit gray (H, W) uint16; every
  row takes filter type 0 (None) and the image one IDAT chunk, deflated
  at ``level`` (1 by default, cv2's default);
- ``write_tiff16``: a baseline little-endian TIFF of a (H, W) uint16
  image, uncompressed, in one strip (the C3VD depth format's layout).

The files are not byte-equal to cv2's, but they decode to the same
pixels through PIL, cv2 and the port's own readers (``data/native``).
"""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types by channel count: gray, RGB.
_PNG_COLOUR = {1: 0, 3: 2}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", binascii.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, bgr: bool = False,
              level: int = 1) -> None:
    """Write an 8-bit gray or RGB, or a 16-bit gray, image as a PNG."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in _PNG_COLOUR or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) images, got "
                         f"shape {img.shape}")
    if img.dtype == np.uint16 and channels == 1:
        bits, rows = 16, img.astype(">u2")
    elif img.dtype == np.uint8:
        bits, rows = 8, img[..., ::-1] if bgr and channels == 3 else img
    else:
        raise ValueError(f"write_png takes uint8 gray or RGB, or uint16 "
                         f"gray, got {img.dtype} with {channels} channels")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + w * channels * bits // 8), np.uint8)
    raw[:, 1:] = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, bits, _PNG_COLOUR[channels], 0, 0,
                         0)
    data = (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


# TIFF field types.
_SHORT, _LONG = 3, 4


def write_tiff16(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint16 image as a baseline TIFF: little-endian,
    uncompressed, one strip, BlackIsZero."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError(f"write_tiff16 takes (H, W) uint16, got "
                         f"{img.dtype} of shape {img.shape}")
    h, w = img.shape
    pixels = np.ascontiguousarray(img, "<u2").tobytes()
    entries = [(256, _LONG, w), (257, _LONG, h), (258, _SHORT, 16),
               (259, _SHORT, 1), (262, _SHORT, 1), (273, _LONG, 0),
               (277, _SHORT, 1), (278, _LONG, h),
               (279, _LONG, len(pixels)), (284, _SHORT, 1)]
    ifd_size = 2 + 12 * len(entries) + 4
    data_offset = 8 + ifd_size
    ifd = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        if tag == 273:
            value = data_offset
        fmt = "<HHIHH" if kind == _SHORT else "<HHII"
        ifd += struct.pack(fmt, tag, kind, 1, value,
                           *((0,) if kind == _SHORT else ()))
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8) + ifd + pixels)
