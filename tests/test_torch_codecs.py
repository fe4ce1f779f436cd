"""The port's image codecs: its PNG and TIFF readers (``data/native``,
its copies of the JAX package's ``pngdec.cpp``/``tiffdec.cpp``, built by
its own ``utils/cbuild.py``) against the JAX package's readers, PIL and
cv2, and its pure-Python writers (``media/imageio``) through all of them.

Every comparison is exact: the codecs are lossless, so any differing
pixel is a fault.
"""

import re
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import e3d_tpu  # noqa: F401
from e3d_tpu.data import native as jnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import io as tio
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import native as tnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import imageio
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.utils import cbuild

HW = (37, 53)  # odd sizes: row strides that are not a multiple of 4


def _image(channels, dtype, seed=0):
    rng = np.random.default_rng(seed)
    top = 65536 if dtype == np.uint16 else 256
    shape = HW if channels == 1 else (*HW, channels)
    return rng.integers(0, top, shape, dtype=dtype)


# Written by PIL, which picks L, LA, RGB, RGBA and I;16 from the arrays.
PIL_FLAVOURS = {"gray8": (1, np.uint8), "gray_alpha8": (2, np.uint8),
                "rgb8": (3, np.uint8), "rgba8": (4, np.uint8),
                "gray16": (1, np.uint16)}


@pytest.mark.parametrize("flavour", sorted(PIL_FLAVOURS))
def test_png_reader_matches_jax_reader_and_pil(flavour, tmp_path):
    channels, dtype = PIL_FLAVOURS[flavour]
    img = _image(channels, dtype)
    path = str(tmp_path / f"{flavour}.png")
    Image.fromarray(img).save(path)
    got = tnative.decode_png_batch([path, path])
    assert got.dtype == dtype and got.shape == (2, *img.shape)
    np.testing.assert_array_equal(got, jnative.decode_png_batch([path, path]))
    np.testing.assert_array_equal(got[0], np.asarray(Image.open(path)))
    assert tnative.png_info(path) == (*HW, channels, 8 * img.itemsize)


def test_png_reader_16bit_rgb_matches_jax_reader_and_cv2(tmp_path):
    """PIL reads 16-bit RGB PNGs as 8-bit, so cv2 is the oracle here."""
    img = _image(3, np.uint16)
    path = str(tmp_path / "rgb16.png")
    assert cv2.imwrite(path, img[..., ::-1])
    got = tnative.decode_png_batch([path])[0]
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jnative.decode_png_batch([path])[0])
    np.testing.assert_array_equal(
        got, cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1])


def test_tiff_reader_matches_cv2_and_jax_reader(tmp_path):
    img = _image(1, np.uint16, seed=1)
    path = str(tmp_path / "depth.tiff")
    assert cv2.imwrite(path, img)  # cv2's own choice of compression
    got = tnative.decode_tiff(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, jnative.decode_tiff(path))


WRITER_CASES = {"gray8": _image(1, np.uint8, 2), "rgb8": _image(3, np.uint8, 3),
                "gray16": _image(1, np.uint16, 4)}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
def test_png_writer_decodes_equal_everywhere(case, bgr, tmp_path):
    img = WRITER_CASES[case]
    path = str(tmp_path / f"{case}.png")
    imageio.write_png(path, img, bgr=bgr)
    rgb = img[..., ::-1] if bgr and img.ndim == 3 else img
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)
    via_cv2 = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(
        via_cv2[..., ::-1] if via_cv2.ndim == 3 else via_cv2, rgb)
    np.testing.assert_array_equal(tnative.decode_png_batch([path])[0], rgb)
    np.testing.assert_array_equal(jnative.decode_png_batch([path])[0], rgb)


def test_tiff_writer_decodes_equal_everywhere(tmp_path):
    img = _image(1, np.uint16, seed=5)
    path = str(tmp_path / "d.tiff")
    imageio.write_tiff16(path, img)
    np.testing.assert_array_equal(tnative.decode_tiff(path), img)
    np.testing.assert_array_equal(jnative.decode_tiff(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("bad", [np.zeros(HW, np.float32),
                                 np.zeros((*HW, 4), np.uint8),
                                 np.zeros((*HW, 3), np.uint16)],
                         ids=["float", "rgba", "rgb16"])
def test_png_writer_refuses_what_it_does_not_write(bad, tmp_path):
    with pytest.raises(ValueError, match="write_png takes"):
        imageio.write_png(str(tmp_path / "x.png"), bad)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _adam7_png(img: np.ndarray) -> bytes:
    """A real interlaced 8-bit RGB PNG (PIL does not write them)."""
    h, w = img.shape[:2]
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_unsupported_pngs_raise_and_name_their_format(tmp_path):
    img = _image(3, np.uint8, seed=6)
    interlaced = tmp_path / "adam7.png"
    interlaced.write_bytes(_adam7_png(img))
    # PIL reads it (the JAX package's fallback); the port refuses it.
    np.testing.assert_array_equal(np.asarray(Image.open(interlaced)), img)
    palette = str(tmp_path / "palette.png")
    Image.fromarray(img).convert("P").save(palette)
    truncated = tmp_path / "cut.png"
    whole = tmp_path / "whole.png"
    imageio.write_png(str(whole), img)
    truncated.write_bytes(whole.read_bytes()[:200])
    for path, name in ((interlaced, "8-bit RGB interlaced (Adam7) PNG"),
                       (palette, "8-bit palette PNG"),
                       (truncated, "truncated 8-bit RGB PNG")):
        with pytest.raises(ValueError, match=re.escape(name)):
            tio.decode_rgb(str(path))
    with pytest.raises(ValueError, match=r"\.bmp images are not read"):
        tio.decode_rgb(str(tmp_path / "x.bmp"))


def test_pngdec_links_zlib_and_the_flag_is_in_its_hash():
    assert cbuild.HOST_LINK["host/pngdec"] == ("-lz",)
    cmd = cbuild._command("host/pngdec", cbuild.library_path("host/pngdec"))
    assert cmd[-1] == "-lz"
    saved = cbuild.HOST_LINK
    try:
        cbuild.HOST_LINK = {}
        unlinked = cbuild.library_path("host/pngdec")
    finally:
        cbuild.HOST_LINK = saved
    assert unlinked != cbuild.library_path("host/pngdec")
    assert "-lz" not in cbuild._command("host/tiffdec", "x.so")
