"""ctypes bindings for the native reconstruction kernels (meshing.cpp).

The port's counterpart of the JAX package's ``recon/native``: the C++
source is the port's own copy (``csrc/host/meshing.cpp``), built by the
port's ``utils/cbuild.py`` as ``host/meshing`` into ``build/host/`` at
first use, never at import. A failed build raises with the compiler's
output. ``E3D_MESH_THREADS`` sets the mesher's thread count (read by the
C++); with one thread the dense and the sparse mesher walk cells in the
same order, so their welded output is bit-equal.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils import cbuild

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = cbuild.load("host/meshing")
            lib.e3d_estimate_normals.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.e3d_estimate_normals.restype = None
            lib.e3d_marching_tetrahedra.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64)]
            lib.e3d_marching_tetrahedra.restype = ctypes.c_int
            lib.e3d_marching_tetrahedra_cells.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64)]
            lib.e3d_marching_tetrahedra_cells.restype = ctypes.c_int
            lib.e3d_free.argtypes = [ctypes.c_void_p]
            lib.e3d_free.restype = None
            _LIB = lib
        return _LIB


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def estimate_normals(points: np.ndarray, radius: float = 0.1,
                     max_nn: int = 30,
                     orient_toward: np.ndarray | None = None) -> np.ndarray:
    """PCA normals with Open3D hybrid-search semantics (the reference's
    radius 0.1, max_nn 30).

    ``orient_toward``: optional (3,) or (N, 3) viewpoint(s); normals are
    flipped to face them (needed for a consistent Poisson field).
    """
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    out = np.empty((n, 3), np.float32)
    if n:
        _lib().e3d_estimate_normals(_fptr(points), n, float(radius),
                                    int(max_nn), _fptr(out))
    if orient_toward is not None and n:
        view = np.asarray(orient_toward, np.float32)
        to_view = view - points if view.ndim == 2 else view[None] - points
        flip = np.sum(out * to_view, axis=1) < 0
        out[flip] *= -1
    return out


def _take_mesh(verts_p, n_verts, tris_p, n_tris
               ) -> tuple[np.ndarray, np.ndarray]:
    """Copy the mesher's malloc'd outputs into numpy, then free them."""
    try:
        verts = np.ctypeslib.as_array(verts_p, (n_verts.value, 3)).copy() \
            if n_verts.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tris_p, (n_tris.value, 3)).copy() \
            if n_tris.value else np.zeros((0, 3), np.int32)
    finally:
        _lib().e3d_free(ctypes.cast(verts_p, ctypes.c_void_p))
        _lib().e3d_free(ctypes.cast(tris_p, ctypes.c_void_p))
    return verts, tris


def marching_tetrahedra(field: np.ndarray, iso: float,
                        origin: np.ndarray, spacing: float
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Isosurface of a (nx, ny, nz) scalar field -> (verts (V,3), tris (T,3))."""
    field = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = field.shape
    origin = np.ascontiguousarray(origin, np.float32)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int64()
    n_tris = ctypes.c_int64()
    rc = _lib().e3d_marching_tetrahedra(
        _fptr(field), nx, ny, nz, float(iso), _fptr(origin), float(spacing),
        ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(tris_p), ctypes.byref(n_tris))
    if rc != 0:
        raise MemoryError("marching_tetrahedra allocation failed")
    return _take_mesh(verts_p, n_verts, tris_p, n_tris)


def marching_tetrahedra_cells(cell_ids: np.ndarray,
                              corner_vals: np.ndarray,
                              grid_shape: tuple[int, int, int], iso: float,
                              origin: np.ndarray, spacing: float
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Sparse isosurface over active cells only.

    cell_ids: (K,) int32 flat corner-grid ids of each cell's (0,0,0)
    corner; corner_vals: (K, 8) f32 in the cube-corner order of the dense
    mesher. Produces the same welded mesh as the dense path restricted to
    those cells.
    """
    _, ny, nz = grid_shape
    cell_ids = np.ascontiguousarray(cell_ids, np.int32)
    corner_vals = np.ascontiguousarray(corner_vals, np.float32)
    if corner_vals.shape != (len(cell_ids), 8):
        # raw-pointer boundary: a bare assert vanishes under python -O
        raise ValueError(f"corner_vals must be ({len(cell_ids)}, 8), "
                         f"got {corner_vals.shape}")
    origin = np.ascontiguousarray(origin, np.float32)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int64()
    n_tris = ctypes.c_int64()
    rc = _lib().e3d_marching_tetrahedra_cells(
        cell_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(corner_vals), len(cell_ids), ny, nz, float(iso),
        _fptr(origin), float(spacing),
        ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(tris_p), ctypes.byref(n_tris))
    if rc != 0:
        raise MemoryError("marching_tetrahedra_cells allocation failed")
    return _take_mesh(verts_p, n_verts, tris_p, n_tris)
