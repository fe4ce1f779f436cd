"""PLY point-cloud / mesh I/O (binary little-endian + ascii), the JAX
package's ``recon/ply.py``: host numpy, and the files it writes are byte
for byte the JAX writer's.

Replaces Open3D's PLY writer used by the reference (its
``depth_to_pointcloud.py:368-371``, ``depth_to_pointcloud_dav2.py:317-326``).
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None,
              normals: np.ndarray | None = None,
              triangles: np.ndarray | None = None,
              binary: bool = True) -> None:
    """Write points (N, 3) [+ colors in [0,1] or uint8, normals,
    triangle indices (M, 3)] as PLY."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [points]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        fields.append(np.asarray(normals, np.float32))
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if triangles is not None:
        triangles = np.asarray(triangles, np.int32)
        header += [f"element face {len(triangles)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            vert = np.concatenate(
                [fl.astype("<f4").view(np.uint8).reshape(n, -1)
                 for fl in fields] +
                ([colors.reshape(n, 3)] if colors is not None else []),
                axis=1)
            f.write(vert.tobytes())
            if triangles is not None:
                face = np.empty((len(triangles), 13), np.uint8)
                face[:, 0] = 3
                face[:, 1:] = triangles.astype("<i4").view(np.uint8).reshape(
                    len(triangles), 12)
                f.write(face.tobytes())
        else:
            cols = colors if colors is not None else None
            for i in range(n):
                row = " ".join(f"{v:.6f}" for fl in fields for v in fl[i])
                if cols is not None:
                    row += " " + " ".join(str(int(c)) for c in cols[i])
                f.write((row + "\n").encode("ascii"))
            if triangles is not None:
                for tri in triangles:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))


def read_ply(path: str):
    """Minimal PLY reader (for round-trip tests): returns dict with
    'points', optional 'colors'/'normals'/'triangles'."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    binary = any("binary_little_endian" in line for line in header)
    n_vertex = n_face = 0
    props: list[tuple[str, str]] = []
    current = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            current = parts[1]
            if current == "vertex":
                n_vertex = int(parts[2])
            elif current == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and current == "vertex":
            props.append((parts[1], parts[2]))

    names = [p[1] for p in props]
    fmts = {"float": "<f4", "uchar": "u1"}
    if binary:
        dtype = np.dtype([(nm, fmts[tp]) for tp, nm in props])
        vert = np.frombuffer(data, dtype=dtype, count=n_vertex,
                             offset=head_end)
        offset = head_end + n_vertex * dtype.itemsize
        tris = None
        if n_face:
            fdtype = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
            tris = np.frombuffer(data, dtype=fdtype, count=n_face,
                                 offset=offset)["idx"].copy()
    else:
        lines = data[head_end:].decode("ascii").splitlines()
        vert_rows = [line.split() for line in lines[:n_vertex]]
        vert = {nm: np.array([float(r[i]) for r in vert_rows])
                for i, nm in enumerate(names)}
        tris = None
        if n_face:
            tris = np.array([[int(x) for x in line.split()[1:4]]
                             for line in lines[n_vertex:n_vertex + n_face]])

    def col(*ns):
        return np.stack([np.asarray(vert[nm], np.float32) for nm in ns],
                        axis=1)

    out = {"points": col("x", "y", "z")}
    if "red" in names:
        out["colors"] = col("red", "green", "blue") / 255.0
    if "nx" in names:
        out["normals"] = col("nx", "ny", "nz")
    if tris is not None:
        out["triangles"] = tris
    return out
