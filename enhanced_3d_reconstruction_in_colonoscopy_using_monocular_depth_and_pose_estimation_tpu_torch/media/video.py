"""Video ingestion: video -> frames, AVI -> MP4, for MJPEG streams.

The port of the JAX package's ``media/video.py``, native paths only
(``media/native``: C++ RIFF/ISO-BMFF demux and a baseline JPEG codec).
Frame extraction without crop is a lossless byte copy of the stored JPEG;
with a crop the frame is decoded, cropped and re-encoded at quality 95.
AVI -> MP4 is a lossless remux. Where the JAX package falls back to cv2
(a container that does not parse, or a codec other than MJPEG), the port
has no cv2 to fall back to and raises, naming the codec.
"""

from __future__ import annotations

import os

from . import native


def open_mjpeg(video_path: str) -> native.VideoReader:
    """A native reader of an MJPEG AVI/MP4 with at least one frame; raises
    ``FileNotFoundError`` for a missing file and ``ValueError`` for a
    container that does not parse or a stream that is not MJPEG."""
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"cannot open video: {video_path}")
    r = native.VideoReader(video_path)
    if not r.is_mjpeg:
        r.close()
        raise ValueError(f"{video_path}: stream codec {r.fourcc!r} is not "
                         "MJPEG; the port decodes MJPEG AVI/MP4 only")
    if r.num_frames == 0:
        r.close()
        raise ValueError(f"{video_path}: no frames")
    return r


def _validate_crop(crop: dict | None) -> dict | None:
    """Falsy/empty -> None; present but missing width/height -> an error."""
    if not crop:
        return None
    if "width" not in crop or "height" not in crop:
        raise ValueError(f"crop needs width and height, got {dict(crop)}")
    return crop


def video_to_frames(video_path: str, output_dir: str,
                    start_time: float = 0.0, end_time: float | None = None,
                    crop: dict | None = None, test: bool = False,
                    test_frames: int = 10, every_n: int = 1) -> int:
    """Extract frames as ``frame_%04d.jpg``; returns the number written.

    crop: {'x', 'y', 'width', 'height'} (clamped to the frame bounds, like
    the reference's slice indexing). Test mode writes at most
    ``test_frames`` frames into ``output_dir/test``."""
    if test:
        output_dir = os.path.join(output_dir, "test")
    crop = _validate_crop(crop)
    with open_mjpeg(video_path) as r:
        fps = r.fps or 30.0
        start_frame = int(start_time * fps)
        end_frame = (int(end_time * fps) if end_time is not None
                     else r.num_frames)
        end_frame = min(end_frame, r.num_frames)
        os.makedirs(output_dir, exist_ok=True)
        written = 0
        for idx in range(start_frame, end_frame):
            if (idx - start_frame) % every_n:
                continue
            out = os.path.join(output_dir, f"frame_{written:04d}.jpg")
            if crop is None:
                # The stored sample is a JPEG: a lossless, decode-free copy.
                data = r.frame_bytes(idx)
            else:
                img = r.frame_rgb(idx)
                y0 = max(0, int(crop.get("y", 0)))
                x0 = max(0, int(crop.get("x", 0)))
                y1 = min(img.shape[0], y0 + int(crop["height"]))
                x1 = min(img.shape[1], x0 + int(crop["width"]))
                # quality 95 = cv2.imwrite's default, which the reference
                # uses
                data = native.encode_jpeg(img[y0:y1, x0:x1], 95)
            with open(out, "wb") as f:
                f.write(data)
            written += 1
            if test and written >= test_frames:
                break
    return written


def convert_avi_to_mp4(avi_path: str, mp4_path: str | None = None) -> str:
    """Re-container an MJPEG AVI as MP4: the JPEG samples are copied
    bit-exact into an ISO-BMFF ``jpeg`` track (the reference re-encodes to
    mp4v; the JAX package remuxes MJPEG the same way)."""
    if mp4_path is None:
        mp4_path = os.path.splitext(avi_path)[0] + ".mp4"
    with open_mjpeg(avi_path) as r:
        with native.VideoWriter(mp4_path, r.width, r.height,
                                r.fps or 30.0,  # 0 fps AVI headers
                                container="mp4") as wr:
            for i in range(r.num_frames):
                wr.write_jpeg(r.frame_bytes(i))
    return mp4_path
