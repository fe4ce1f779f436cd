"""Host-side dataset IO: file pairing, decode, blacklists.

The JAX package's ``data/io.py`` with the port's own readers:

- SimCol folders pair ``FrameBuffer_*.png`` (RGB) with ``Depth_*.png``
  (16-bit); ``load_frames`` splits on the Depth/Frame filename markers.
- Split lists are comma-separated folder names.
- Validation drops 3 known-bad SyntheticColon_I/Frames_S14 frames,
  keeping frames and positions aligned.
- C3VD pairs ``*_color.png`` / ``[0-9]*_*.png`` with ``{n}_depth.tiff``
  (zero-pad fallback); colour goes BGR->RGB as cv2 reads it, uint16
  colour is cut to uint8.
- ``imread_unchanged``, ``imread_grayscale`` and ``imread_anydepth`` read
  a PNG as ``cv2.imread`` does with ``IMREAD_UNCHANGED``,
  ``IMREAD_GRAYSCALE`` and ``IMREAD_ANYDEPTH``: cv2's channel order
  (BGR, BGRA) and libpng's RGB->gray, which cv2's PNG reader asks for.

PNGs go through ``data/native`` (the port's copy of ``pngdec.cpp``),
JPEGs through ``media/native`` and TIFFs through ``data/native``
(``tiffdec.cpp``). Where the JAX package falls back to PIL or cv2 (an
interlaced, palette or low-bit-depth PNG, a progressive JPEG, a tiled or
otherwise compressed TIFF, any other format), the port has neither and
raises ``ValueError`` naming the file's format.
"""

from __future__ import annotations

import glob as globlib
import os
import struct

import numpy as np

from . import native

BAD_VAL_FRAMES = (
    "SyntheticColon_I/Frames_S14/FrameBuffer_0059.png",
    "SyntheticColon_I/Frames_S14/FrameBuffer_0060.png",
    "SyntheticColon_I/Frames_S14/FrameBuffer_0061.png",
)

_PNG_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                     6: "RGBA"}


def read_split_list(path: str) -> list[str]:
    """Comma-separated folder list file -> folder names."""
    with open(path, "r", encoding="utf-8") as f:
        return [x.strip() for x in f.read().strip().split(",") if x.strip()]


def load_frames(directory: str) -> tuple[list[str], list[str]]:
    """Sorted (depth_paths, rgb_paths) for one SimCol-style folder."""
    depth, rgb = [], []
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".png"):
            continue
        full = os.path.join(directory, name)
        if "Depth" in name:
            depth.append(full)
        elif "Frame" in name:
            rgb.append(full)
    return depth, rgb


def remove_bad_frames(root: str, rgb_list: list[str], depth_list: list[str],
                      positions: list | None = None):
    """Drop the blacklisted validation frames, keeping all lists aligned."""
    bad_rgb = {os.path.join(root, f) for f in BAD_VAL_FRAMES}
    keep = [i for i, p in enumerate(rgb_list) if p not in bad_rgb]
    rgb_out = [rgb_list[i] for i in keep]
    depth_out = [depth_list[i] for i in keep]
    pos_out = [positions[i] for i in keep] if positions is not None else None
    return rgb_out, depth_out, pos_out


def process_images(train_vids: list[str], val_vids: list[str],
                   test_vids: list[str], input_path: str):
    """Collect depth/rgb frame lists per split folder list and drop the
    validation blacklist. Returns (train_depth, train_rgb, val_depth,
    val_rgb, test_depth, test_rgb)."""
    splits = []
    for vids in (train_vids, val_vids, test_vids):
        depth, rgb = [], []
        for vid in vids:
            d, r = load_frames(vid)
            depth.extend(d)
            rgb.extend(r)
        splits.append((depth, rgb))
    val_depth, val_rgb = splits[1]
    val_rgb, val_depth, _ = remove_bad_frames(input_path, val_rgb, val_depth)
    splits[1] = (val_depth, val_rgb)
    for depth, rgb in splits:
        if len(depth) != len(rgb):
            raise ValueError("Mismatch in split data")
    return (splits[0][0], splits[0][1], splits[1][0], splits[1][1],
            splits[2][0], splits[2][1])


def describe_png(path: str) -> str:
    """The PNG flavour of ``path`` from its header and chunk list, e.g.
    "8-bit RGB interlaced (Adam7) PNG" or "truncated 8-bit RGB PNG"."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 33 or data[:8] != b"\x89PNG\r\n\x1a\n" \
            or data[12:16] != b"IHDR":
        return "truncated or corrupt PNG"
    bits, colour, _, _, interlace = struct.unpack(">BBBBB", data[24:29])
    kind = _PNG_COLOUR_NAMES.get(colour, f"colour type {colour}")
    flavour = (f"{bits}-bit {kind}"
               f"{' interlaced (Adam7)' if interlace else ''} PNG")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IEND":
            return flavour
        pos += 12 + length
    return f"truncated {flavour}"


def _decode_png(path: str) -> np.ndarray:
    """One PNG -> (H, W) or (H, W, C), uint8 or uint16."""
    try:
        return native.decode_png_batch([path])[0]
    except ValueError:
        raise ValueError(
            f"{path}: {describe_png(path)} is not read by the port (it "
            "reads whole, non-interlaced 8-bit gray, gray+alpha, RGB and "
            "RGBA, and 16-bit gray and RGB PNGs)") from None


def _decode_jpeg(path: str) -> np.ndarray:
    from ..media import native as media_native

    with open(path, "rb") as f:
        data = f.read()
    try:
        return media_native.decode_jpeg(data)
    except ValueError as exc:
        raise ValueError(f"{path}: progressive, arithmetic-coded, 12-bit "
                         f"or corrupt JPEG is not read by the port "
                         f"({exc})") from None


def _unsupported(path: str) -> ValueError:
    ext = os.path.splitext(path)[1] or "(no extension)"
    return ValueError(f"{path}: {ext} images are not read by the port "
                      "(PNG and baseline JPEG)")


def _to_rgb3(arr: np.ndarray) -> np.ndarray:
    """Any decoded layout -> (H, W, 3): gray and gray+alpha replicate the
    luma channel, RGBA drops alpha."""
    if arr.ndim == 2:
        return np.stack([arr] * 3, axis=-1)
    if arr.shape[2] == 2:  # gray + alpha
        return np.stack([arr[:, :, 0]] * 3, axis=-1)
    return arr[:, :, :3]


def decode_rgb(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a PNG or JPEG; drops alpha, cuts 16-bit
    samples to 8 (``// 256``)."""
    lower = path.lower()
    if lower.endswith((".jpg", ".jpeg")):
        arr = _decode_jpeg(path)
    elif lower.endswith(".png"):
        arr = _decode_png(path)
    else:
        raise _unsupported(path)
    arr = _to_rgb3(arr)
    if arr.dtype == np.uint16:
        arr = (arr // 256).astype(np.uint8)
    return np.ascontiguousarray(arr)


def decode_depth16_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> uint16 (H, W)."""
    return _decode_png(path).astype(np.uint16)


def decode_c3vd_color(path: str) -> np.ndarray:
    """C3VD colour frame as cv2 reads it and converts BGR->RGB: the file's
    RGB (gray replicated, alpha dropped), uint16 cut to uint8 by
    ``(img / 256).astype(np.uint8)``."""
    lower = path.lower()
    if lower.endswith(".png"):
        img = _decode_png(path)
    elif lower.endswith((".jpg", ".jpeg")):
        img = _decode_jpeg(path)
    else:
        raise _unsupported(path)
    if img.ndim == 3 and img.shape[2] == 2:
        raise ValueError(f"{path}: {describe_png(path)} has no BGR->RGB "
                         "conversion (cv2 refuses it too)")
    img = _to_rgb3(img)
    if img.dtype == np.uint16:
        img = (img / 256).astype(np.uint8)
    return np.ascontiguousarray(img)


def decode_c3vd_depth(path: str) -> np.ndarray:
    """C3VD 16-bit depth TIFF -> uint16 (H, W): baseline striped TIFFs,
    uncompressed, LZW or PackBits (the formats C3VD ships)."""
    try:
        return native.decode_tiff(path).astype(np.uint16, copy=False)
    except ValueError as exc:
        raise ValueError(f"{path}: tiled, otherwise compressed or corrupt "
                         f"TIFF is not read by the port ({exc})") from None


def pair_c3vd_folder(folder_path: str) -> tuple[list[str], list[str]]:
    """Color/depth pairing with zero-pad fallback."""
    color = sorted(globlib.glob(os.path.join(folder_path, "*_color.png")))
    color.extend(sorted(globlib.glob(
        os.path.join(folder_path, "[0-9]*_*.png"))))
    # de-dup while keeping order (both patterns can match the same file)
    seen: set[str] = set()
    color = [c for c in color if not (c in seen or seen.add(c))]

    images, depths = [], []
    for img_path in color:
        base = os.path.basename(img_path).split("_")[0]
        candidates = [f"{base}_depth.tiff"]
        if base.isdigit():
            candidates.append(f"{int(base):04d}_depth.tiff")
        depth_file = None
        for cand in candidates:
            p = os.path.join(os.path.dirname(img_path), cand)
            if os.path.exists(p):
                depth_file = p
                break
        if depth_file is not None:
            images.append(img_path)
            depths.append(depth_file)
    return images, depths


def load_pose_files(data_dir: str, folder: str
                    ) -> tuple[np.ndarray, np.ndarray] | None:
    """SavedPosition_*/SavedRotationQuaternion_* for one procedure folder:
    the files live next to the Frames_ dir, suffixed with the frame-folder
    id."""
    version = folder.split("/")[0]
    frame_id = folder.split("_")[-1]
    pos_file = os.path.join(data_dir, version, f"SavedPosition_{frame_id}.txt")
    rot_file = os.path.join(data_dir, version,
                            f"SavedRotationQuaternion_{frame_id}.txt")
    if not (os.path.exists(pos_file) and os.path.exists(rot_file)):
        return None
    positions = np.loadtxt(pos_file)
    orientations = np.loadtxt(rot_file)
    if positions.ndim == 1:
        positions = positions.reshape(1, -1)
    if orientations.ndim == 1:
        orientations = orientations.reshape(1, -1)
    if positions.shape[1] != 3 or orientations.shape[1] != 4:
        return None
    return positions.astype(np.float32), orientations.astype(np.float32)


# libpng's RGB->gray (png_set_rgb_to_gray with cv2's 0.299 / 0.587, as
# 15-bit fixed-point coefficients that truncate): 8-bit samples truncate,
# 16-bit ones round.
_GRAY_COEFFS = (9797, 19234, 3737)


def _png_gray(img: np.ndarray) -> np.ndarray:
    """A decoded PNG (RGB(A) order) -> gray at its own depth, as libpng
    converts it for cv2; gray and gray+alpha keep their gray channel."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return np.ascontiguousarray(img[:, :, 0])
    r, g, b = (img[:, :, c].astype(np.int64) for c in range(3))
    cr, cg, cb = _GRAY_COEFFS
    rnd = 1 << 14 if img.dtype == np.uint16 else 0
    return ((cr * r + cg * g + cb * b + rnd) >> 15).astype(img.dtype)


def _png_only(path: str) -> None:
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port reads only PNGs here "
                         "(cv2.imread's flags are matched for PNG)")


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: the file's depth and
    channels in cv2's order: gray (H, W), BGR (H, W, 3), BGRA (H, W, 4);
    gray+alpha becomes BGRA with the gray replicated. A baseline JPEG
    comes back BGR."""
    if path.lower().endswith((".jpg", ".jpeg")):
        return np.ascontiguousarray(_decode_jpeg(path)[:, :, ::-1])
    _png_only(path)
    img = _decode_png(path)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        gray, alpha = img[:, :, 0], img[:, :, 1]
        return np.ascontiguousarray(np.stack([gray, gray, gray, alpha], -1))
    order = [2, 1, 0, 3][:img.shape[2]]
    return np.ascontiguousarray(img[:, :, order])


def imread_grayscale(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: uint8 (H, W); colour
    through libpng's RGB->gray, 16-bit samples cut to 8 (``>> 8``)."""
    _png_only(path)
    gray = _png_gray(_decode_png(path))
    if gray.dtype == np.uint16:
        gray = (gray >> 8).astype(np.uint8)
    return gray


def imread_anydepth(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``: gray (H, W) at the file's
    depth (uint8 or uint16); colour through libpng's RGB->gray."""
    _png_only(path)
    return _png_gray(_decode_png(path))
