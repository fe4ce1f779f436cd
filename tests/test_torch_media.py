"""The port's media stack against the JAX package's: the native JPEG codec
and AVI/MP4 containers (the port builds its own copies of the same C++
sources with the same flags, so pixels and bytes must be equal), the
colormaps (matplotlib's tables, kept in the port), frame extraction and
the AVI -> MP4 remux; and the errors that take the place of the JAX
package's cv2 fallbacks.
"""

import os

import matplotlib
import numpy as np
import pytest

import e3d_tpu  # noqa: F401
from e3d_tpu.media import colormap as jcm
from e3d_tpu.media import native as jnative
from e3d_tpu.media import video as jvideo
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import colormap as tcm
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import native as tnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import video as tvideo
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.utils import cbuild


def _smooth_rgb(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.standard_normal((h, w, 3)), axis=1),
                    axis=0)
    return ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)


def _frames(n=5, h=48, w=64):
    return [_smooth_rgb(h, w, seed=i) for i in range(n)]


def test_port_builds_its_own_codec_libraries(tmp_path):
    data = jnative.encode_jpeg(_smooth_rgb(), 90)
    tnative.jpeg_info(data)  # loads (building if needed) the JPEG codec
    with tnative.VideoWriter(str(tmp_path / "x.avi"), 64, 48) as w:
        w.write_jpeg(data)  # and the containers
    for name in ("host/jpegcodec", "host/container"):
        path = cbuild.library_path(name)
        assert path.exists() and path.parent == cbuild.HOST_BUILD_DIR
    jax_dir = os.path.dirname(jnative.__file__)
    assert not str(cbuild.library_path("host/jpegcodec")).startswith(jax_dir)


@pytest.mark.parametrize("quality", [50, 90, 95])
@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_encode_bytes_and_decode_pixels_equal(quality, gray):
    img = _smooth_rgb(37, 53, seed=quality)
    img = img[..., 0] if gray else img
    data = tnative.encode_jpeg(img, quality)
    assert data == jnative.encode_jpeg(img, quality)
    assert tnative.jpeg_info(data) == jnative.jpeg_info(data)
    np.testing.assert_array_equal(tnative.decode_jpeg(data),
                                  jnative.decode_jpeg(data))


def test_jpeg_refuses_what_the_codec_does_not_take():
    with pytest.raises(ValueError):
        tnative.decode_jpeg(b"\xff\xd8not a jpeg")
    with pytest.raises(ValueError):
        tnative.encode_jpeg(np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("ext", ["avi", "mp4"])
def test_container_round_trip_and_interop(ext, tmp_path):
    """The port's writer gives the JAX writer's file byte for byte, and
    each package reads the other's file back."""
    frames = _frames()
    paths = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        paths[name] = str(tmp_path / f"{name}.{ext}")
        with mod.VideoWriter(paths[name], 64, 48, fps=29.97) as w:
            for f in frames:
                w.write_rgb(f, quality=90)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    with tnative.VideoReader(paths["jax"]) as r, \
            jnative.VideoReader(paths["port"]) as jr:
        assert (r.width, r.height, r.num_frames, r.is_mjpeg) == \
            (64, 48, 5, True) == (jr.width, jr.height, jr.num_frames,
                                  jr.is_mjpeg)
        assert abs(r.fps - 29.97) < 1e-6 and r.fps == jr.fps
        for i in range(5):
            assert r.frame_bytes(i) == jr.frame_bytes(i)
            np.testing.assert_array_equal(r.frame_rgb(i), jr.frame_rgb(i))


@pytest.mark.parametrize("name,table", [("Spectral", tcm.SPECTRAL),
                                        ("Spectral_r", tcm.SPECTRAL_R)])
def test_colormap_tables_are_matplotlibs(name, table):
    cmap = matplotlib.colormaps.get_cmap(name)
    want = (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("bgr", [False, True])
def test_colorize_and_side_by_side_equal_the_jax_package(grayscale, bgr):
    rng = np.random.default_rng(int(grayscale) + 2 * int(bgr))
    depth = rng.uniform(0.1, 20.0, (40, 52)).astype(np.float32)
    got = tcm.colorize_depth(depth, grayscale=grayscale, bgr=bgr)
    np.testing.assert_array_equal(
        got, jcm.colorize_depth(depth, grayscale=grayscale, bgr=bgr))
    raw = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcm.side_by_side(raw, got),
                                  jcm.side_by_side(raw, got))
    flat = np.full((8, 8), 3.0, np.float32)  # hi == lo: all index 0
    np.testing.assert_array_equal(tcm.colorize_depth(flat, grayscale, bgr),
                                  jcm.colorize_depth(flat, grayscale, bgr))


def test_depth_to_heatmap_equals_the_jax_package():
    rng = np.random.default_rng(7)
    for depth in (rng.uniform(0.0, 5.0, (33, 47)).astype(np.float32),
                  rng.uniform(0.0, 5.0, (9, 9)),  # float64
                  np.linspace(0.0, 1.0, 256 * 3).reshape(48, 16)):
        np.testing.assert_array_equal(tcm.depth_to_heatmap(depth),
                                      jcm.depth_to_heatmap(depth))


@pytest.mark.parametrize("crop", [None, {"x": 5, "y": 3, "width": 40,
                                         "height": 100}])
def test_video_to_frames_equals_the_jax_package(crop, tmp_path):
    src = str(tmp_path / "in.avi")
    with tnative.VideoWriter(src, 64, 48, fps=10.0) as w:
        for f in _frames(7):
            w.write_rgb(f, quality=90)
    outs = {}
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        out = str(tmp_path / name)
        assert mod.video_to_frames(src, out, start_time=0.1, crop=crop,
                                   every_n=2) == 3
        outs[name] = out
    names = sorted(os.listdir(outs["port"]))
    assert names == sorted(os.listdir(outs["jax"])) == [
        "frame_0000.jpg", "frame_0001.jpg", "frame_0002.jpg"]
    for n in names:
        with open(os.path.join(outs["port"], n), "rb") as a, \
                open(os.path.join(outs["jax"], n), "rb") as b:
            assert a.read() == b.read()
    assert tvideo.video_to_frames(src, outs["port"], test=True,
                                  test_frames=2) == 2
    assert sorted(os.listdir(os.path.join(outs["port"], "test"))) == \
        names[:2]


def test_convert_avi_to_mp4_is_the_jax_remux(tmp_path):
    src = str(tmp_path / "in.avi")
    with tnative.VideoWriter(src, 64, 48, fps=25.0) as w:
        for f in _frames(4):
            w.write_rgb(f, quality=85)
    port = tvideo.convert_avi_to_mp4(src, str(tmp_path / "port.mp4"))
    jax = jvideo.convert_avi_to_mp4(src, str(tmp_path / "jax.mp4"))
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    assert tvideo.convert_avi_to_mp4(src) == str(tmp_path / "in.mp4")


def test_other_codecs_raise_naming_the_codec(tmp_path):
    """Where the JAX package falls back to cv2, the port raises: a
    non-MJPEG stream (here an MP4 whose sample entry says mp4v), a
    container that does not parse, a missing file."""
    path = str(tmp_path / "x.mp4")
    with tnative.VideoWriter(path, 64, 48) as w:
        for f in _frames(2):
            w.write_rgb(f)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    at = data.index(b"jpeg", data.index(b"stsd"))
    data[at:at + 4] = b"mp4v"
    with open(path, "wb") as f:
        f.write(bytes(data))
    with jnative.VideoReader(path) as r:
        assert not r.is_mjpeg and r.fourcc == "mp4v"
    with pytest.raises(ValueError, match="'mp4v' is not MJPEG"):
        tvideo.video_to_frames(path, str(tmp_path / "frames"))
    with pytest.raises(ValueError, match="'mp4v' is not MJPEG"):
        tvideo.convert_avi_to_mp4(path, str(tmp_path / "y.mp4"))
    junk = str(tmp_path / "junk.avi")
    with open(junk, "wb") as f:
        f.write(b"not a container at all")
    with pytest.raises(ValueError, match="unsupported or unreadable"):
        tvideo.open_mjpeg(junk)
    with pytest.raises(FileNotFoundError):
        tvideo.open_mjpeg(str(tmp_path / "missing.avi"))
