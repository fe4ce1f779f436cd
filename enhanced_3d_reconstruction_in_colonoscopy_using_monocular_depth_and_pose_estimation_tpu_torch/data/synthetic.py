"""Synthetic dataset fixtures mimicking the on-disk layouts (the JAX
package's ``data/synthetic.py``).

Generates miniature SimCol (``SyntheticColon_I/Frames_S*``, FrameBuffer/
Depth PNGs, SavedPosition/SavedRotationQuaternion txts, comma-separated
split lists, ``UnityCam/cam.txt``) and C3VD (``*_color.png`` +
``*_depth.tiff``) trees for tests and smoke runs, the layouts the
datasets read. The draws from ``np.random.default_rng(seed)`` come in the
JAX package's order, so one seed gives the same pixels and split lists
there and here; the files are written by the port's own writers
(``media/imageio``) where the JAX package uses PIL and cv2.
"""

from __future__ import annotations

import os

import numpy as np

from ..media.imageio import write_png as _write_png
from ..media.imageio import write_tiff16 as _write_tiff16


def _random_walk_poses(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    positions = np.cumsum(rng.normal(scale=0.05, size=(n, 3)), axis=0)
    quats = rng.normal(size=(n, 4)) * 0.1 + np.array([0, 0, 0, 1.0])
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return positions.astype(np.float32), quats.astype(np.float32)


def make_simcol_fixture(root: str, n_procedures: int = 2,
                        frames_per_proc: int = 6, hw: int = 64,
                        seed: int = 0) -> str:
    """Build ``<root>/SyntheticColon_I/...`` + split lists. Returns root."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "SyntheticColon_I")
    os.makedirs(base, exist_ok=True)
    folders = []
    for p in range(n_procedures):
        folder = f"Frames_S{p + 1}"
        folders.append(f"SyntheticColon_I/{folder}")
        fdir = os.path.join(base, folder)
        os.makedirs(fdir, exist_ok=True)
        positions, quats = _random_walk_poses(rng, frames_per_proc)
        np.savetxt(os.path.join(base, f"SavedPosition_S{p + 1}.txt"),
                   positions)
        np.savetxt(os.path.join(base, f"SavedRotationQuaternion_S{p + 1}.txt"),
                   quats)
        for i in range(frames_per_proc):
            img = rng.integers(0, 255, size=(hw, hw, 3), dtype=np.uint8)
            dep = rng.integers(1000, 60000, size=(hw, hw), dtype=np.uint16)
            _write_png(os.path.join(fdir, f"FrameBuffer_{i:04d}.png"), img)
            _write_png(os.path.join(fdir, f"Depth_{i:04d}.png"), dep)

    # Split lists: comma-separated (reference format).
    half = max(1, n_procedures // 2)
    for name, sel in [("train", folders[:half]), ("val", folders[half:]),
                      ("test", folders[half:])]:
        with open(os.path.join(root, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(",".join(sel) if sel else folders[0])

    # UnityCam intrinsics (flat 3x3; values from the reference
    # datasets/UnityCam/cam.txt).
    cam_dir = os.path.join(root, "UnityCam")
    os.makedirs(cam_dir, exist_ok=True)
    cam = np.array([[156.0418, 0.0, 178.5604],
                    [0.0, 155.7529, 181.8043],
                    [0.0, 0.0, 1.0]])
    np.savetxt(os.path.join(cam_dir, "cam.txt"), cam.reshape(1, 9))
    return root


def make_c3vd_fixture(root: str, n_scenes: int = 1, frames: int = 4,
                      hw: int = 64, seed: int = 0) -> str:
    """Build ``<root>/<scene>/...`` with color PNG + depth tiff pairs."""
    rng = np.random.default_rng(seed)
    scenes = []
    for sidx in range(n_scenes):
        scene = f"cecum_t{sidx + 1}_a"
        scenes.append(scene)
        sdir = os.path.join(root, scene)
        os.makedirs(sdir, exist_ok=True)
        for i in range(frames):
            img = rng.integers(0, 255, size=(hw, hw, 3), dtype=np.uint8)
            dep = rng.integers(1000, 60000, size=(hw, hw), dtype=np.uint16)
            _write_png(os.path.join(sdir, f"{i:04d}_color.png"), img[..., ::-1])
            _write_tiff16(os.path.join(sdir, f"{i:04d}_depth.tiff"), dep)
    for name in ("train", "val", "test"):
        with open(os.path.join(root, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(",".join(scenes))
    return root
