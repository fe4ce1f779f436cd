"""Point-cloud + mesh reconstruction CLI (the port of the JAX package's
``cli/pointcloud.py``, the reference's ``depth_to_pointcloud.py``).

Usage:
    python -m ...cli.pointcloud -i <dataset_root> -ds simcol -o out/ \\
        [--voxel-size 0.01] [--mesh-depth 9] [--max-frames N] \\
        [--device cuda]

Pairs RGB frames with predicted depths from ``Frames_*_OP`` dirs, reads
the camera intrinsics from ``cam.txt`` and each frame's GT pose from
``SavedPosition_*/SavedRotationQuaternion_*``, back-projects every frame
on the device into one world-space cloud, voxel-downsamples it there
(0.01), estimates normals on the host (KD-tree, the port's
``meshing.cpp``), meshes it (Poisson depth-9 analog: the FFT Poisson
solve on the device, marching tetrahedra and 5% density pruning) and
writes ``combined_point_cloud.ply`` / ``combined_mesh.ply``.

A prediction PNG is read as ``cv2.imread(IMREAD_UNCHANGED)`` reads it
(``data.io.imread_unchanged``): a 3-channel one gives its first channel in
cv2's BGR order, the file's blue; a 16-bit single-channel one stays
uint16. A depth of another size than its frame is resized to it by
nearest neighbour. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import time

import numpy as np


def find_frame_pairs(root: str) -> list[tuple[str, str]]:
    """(rgb, predicted_depth) pairs from Frames_* / Frames_*_OP dirs."""
    pairs = []
    for rgb_dir in sorted(glob.glob(os.path.join(
            root, "SyntheticColon_*", "Frames_*"))):
        if rgb_dir.endswith("_OP"):
            continue
        op_dir = rgb_dir + "_OP"
        if not os.path.isdir(op_dir):
            continue
        for rgb in sorted(glob.glob(os.path.join(rgb_dir,
                                                 "FrameBuffer_*.png"))):
            base = os.path.splitext(os.path.basename(rgb))[0]
            for cand in (os.path.join(op_dir, base + ".png"),
                         os.path.join(op_dir,
                                      base.replace("FrameBuffer", "Depth")
                                      + ".png")):
                if os.path.exists(cand):
                    pairs.append((rgb, cand))
                    break
    return pairs


def get_procedure_files(rgb_path: str, root: str):
    """cam.txt + pose files for the procedure containing ``rgb_path``."""
    frames_dir = os.path.dirname(rgb_path)
    colon_dir = os.path.dirname(frames_dir)
    frame_id = os.path.basename(frames_dir).split("_")[-1]
    cam = os.path.join(root, "UnityCam", "cam.txt")
    if not os.path.exists(cam):
        cam = os.path.join(colon_dir, "cam.txt")
    pos = os.path.join(colon_dir, f"SavedPosition_{frame_id}.txt")
    rot = os.path.join(colon_dir, f"SavedRotationQuaternion_{frame_id}.txt")
    return cam, pos, rot


def frame_index(rgb_path: str) -> int:
    m = re.search(r"_(\d+)\.png$", rgb_path)
    return int(m.group(1)) if m else 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--input", required=True,
                   help="dataset root (contains SyntheticColon_*)")
    p.add_argument("-ds", "--ds_type", default="simcol")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--mesh-depth", type=int, default=9,
                   help="Poisson grid depth (2^d per axis; the reference's "
                        "default 9 = 512^3)")
    p.add_argument("--depth-scale", type=float, default=1000.0)
    p.add_argument("--depth-trunc", type=float, default=3.0)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--skip-mesh", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the fusion and the Poisson solve run: cuda "
                        "(default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns its counts (``frames``, ``points_before``,
    ``points_after``, ``verts``, ``tris``), the wall ``seconds`` of
    ``main()`` and the ``stages`` in ms (backprojection, voxel grid,
    normals, and the Poisson stages; device stages on the card's
    clock)."""
    import torch

    from ..core.device import resolve_device
    from ..data.io import decode_rgb, imread_unchanged
    from ..ops.resize import resize_nearest
    from ..recon import (backproject_depth, load_intrinsics, pose_to_matrix,
                         voxel_downsample, write_ply)
    from ..recon.native import estimate_normals
    from ..recon.poisson import poisson_mesh
    from ..recon.stages import StageClock

    t_start = time.perf_counter()
    args = parse_args(argv)
    dev = resolve_device(args.device)
    clock = StageClock(dev)

    pairs = find_frame_pairs(args.input)
    if args.max_frames:
        pairs = pairs[:args.max_frames]
    if not pairs:
        raise SystemExit(f"no (rgb, depth) pairs under {args.input} "
                         "(need Frames_*_OP prediction dirs)")
    print(f"[pointcloud] {len(pairs)} frames")

    all_pts, all_cols = [], []
    pose_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    cam_cache: dict[str, tuple[float, float, float, float]] = {}
    for rgb_path, depth_path in pairs:
        cam_f, pos_f, rot_f = get_procedure_files(rgb_path, args.input)
        if cam_f not in cam_cache:
            cam_cache[cam_f] = load_intrinsics(cam_f)
        fx, fy, cx, cy = cam_cache[cam_f]
        if pos_f not in pose_cache:
            pose_cache[pos_f] = (np.loadtxt(pos_f), np.loadtxt(rot_f))
        positions, quats = pose_cache[pos_f]
        idx = frame_index(rgb_path)
        idx = min(idx, len(positions) - 1)

        depth = imread_unchanged(depth_path)
        if depth.ndim == 3:
            # infer --grayscale predictions are 3 equal channels; of a
            # colourised one this is the blue (cv2's channel 0).
            depth = depth[..., 0]
        color = decode_rgb(rgb_path)
        with clock.stage("backprojection"):
            depth_t = torch.from_numpy(depth.astype(np.float32)).to(dev)
            if depth.shape[:2] != color.shape[:2]:
                depth_t = resize_nearest(depth_t, color.shape[:2],
                                         channels_last=False)
            transform = pose_to_matrix(
                torch.tensor(positions[idx], dtype=torch.float32,
                             device=dev),
                torch.tensor(quats[idx], dtype=torch.float32, device=dev))
            pts, cols, valid = backproject_depth(
                depth_t, fx, fy, cx, cy,
                color=torch.from_numpy(color).to(dev),  # uint8: /255
                depth_scale=args.depth_scale, depth_trunc=args.depth_trunc,
                transform=transform)
            all_pts.append(pts[valid])
            all_cols.append(cols[valid])

    with clock.stage("voxel grid"):
        points = torch.cat(all_pts)
        colors = torch.cat(all_cols)
        n_before = len(points)
        points, colors, _ = voxel_downsample(points, args.voxel_size,
                                             colors=colors)
        del all_pts, all_cols
    print(f"[pointcloud] {n_before} points before downsampling")
    points = points.cpu().numpy()
    colors = colors.cpu().numpy()
    print(f"[pointcloud] {len(points)} points after voxel_down_sample"
          f"({args.voxel_size})")

    os.makedirs(args.outdir, exist_ok=True)
    pc_path = os.path.join(args.outdir, "combined_point_cloud.ply")
    write_ply(pc_path, points, colors=colors)
    print(f"[pointcloud] wrote {pc_path}")

    result = {"frames": len(pairs), "points_before": n_before,
              "points_after": len(points), "verts": 0, "tris": 0}
    if not args.skip_mesh and len(points) > 100:
        with clock.stage("normals", device=False):
            centroid = points.mean(axis=0)
            normals = estimate_normals(
                points, radius=0.1, max_nn=30,
                orient_toward=centroid.astype(np.float32))
        # colon interior: camera looks at the wall from inside; orient
        # toward the centroid then flip (outward-facing surface normals).
        verts, tris = poisson_mesh(points, -normals,
                                   grid_depth=args.mesh_depth,
                                   density_percentile=5.0, device=dev,
                                   clock=clock)
        mesh_path = os.path.join(args.outdir, "combined_mesh.ply")
        write_ply(mesh_path, verts, triangles=tris)
        print(f"[pointcloud] wrote {mesh_path} "
              f"({len(verts)} verts, {len(tris)} tris)")
        result.update(verts=len(verts), tris=len(tris))
    result["stages"] = clock.result()
    result["seconds"] = time.perf_counter() - t_start
    return result


if __name__ == "__main__":
    main()
