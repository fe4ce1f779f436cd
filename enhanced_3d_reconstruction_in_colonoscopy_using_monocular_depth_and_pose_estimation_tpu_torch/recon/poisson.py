"""Poisson surface reconstruction: FFT indicator on the device + native
isosurface (the JAX package's ``recon/poisson.py``).

Replaces Open3D ``create_from_point_cloud_poisson(depth=9)`` and the
reference's 5%-density vertex pruning with the Fourier formulation of
Poisson reconstruction (Kazhdan 2005: the spectral solution of the PDE the
octree solver discretizes):

1. splat oriented normals into a regular vector field V (trilinear
   scatter-add with ``index_add_``, corner by corner);
2. solve laplacian(chi) = div(V): central-difference divergence in real
   space, then spectrally ``chi_hat = div_hat / -|k|^2`` with Gaussian
   regularization, one ``torch.fft.rfftn`` and its inverse;
3. iso level = mean indicator value at the input samples (trilinear
   gather, as in the paper);
4. ``mesh_indicator``: extract the isosurface with the native
   marching-tetrahedra mesher (``recon/native``), densely or over the
   cells that straddle iso only, and prune vertices whose splat density
   falls below a percentile (the reference's ``densities < percentile(5)``
   step).

``grid_depth`` plays the role of Open3D's octree depth: grid size 2^depth.

The splat sums, the divergence, the Gaussian and the FFTs run in f64
(the splat weights, the frequencies and |k|^2 are f32, as in the JAX
package) and chi is rounded to f32 at the end; the iso mean is taken in
f64. So the card's
indicator is the CPU's, bit for bit but for rare roundings, whatever
order the card's atomics and cuFFT sum in. In f32 the two differ in
their last bits, which can move an f16-rounded corner value by a whole
f16 step, and a vertex in a flat part of the field by a large part of a
grid spacing.

The JAX package pads the cloud to a power-of-two bucket for XLA's static
shapes; the port does not pad. Its padding points carry zero normals, are
masked out of the iso mean and put their splat weight at the grid's
corner, ``padding * extent`` from any vertex, so the mesh is the same.

Environment knobs, as in the JAX package: ``E3D_POISSON_SPARSE`` (``1``,
``0``, or ``auto``: sparse at grid >= 256), ``E3D_POISSON_READBACK``
(``f16``, the default, or ``f32``: the precision of the indicator values
the mesher reads) and ``E3D_POISSON_TIMING=1`` (stage times on stderr).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .stages import StageClock

# kCorner order of the mesher (meshing.cpp): (dx, dy, dz) offsets.
_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_OFFSETS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                 for dz in (0, 1))


def _cell_base(points01: torch.Tensor, grid: int):
    """Each point's cell (clipped BEFORE the fraction, so boundary points
    fall in the last cell with frac = 1) and its fraction inside it."""
    pos = points01 * (grid - 1)
    base = torch.clamp(torch.floor(pos).to(torch.int64), 0, grid - 2)
    return base, pos - base.to(pos.dtype)


def _corner_weights(frac: torch.Tensor):
    """(flat-offset tuple, trilinear weight) per cube corner, in the JAX
    package's loop order."""
    for dx, dy, dz in _OFFSETS:
        w = ((frac[:, 0] if dx else 1 - frac[:, 0])
             * (frac[:, 1] if dy else 1 - frac[:, 1])
             * (frac[:, 2] if dz else 1 - frac[:, 2]))
        yield (dx, dy, dz), w


def _flat(base: torch.Tensor, off, grid: int) -> torch.Tensor:
    return ((base[:, 0] + off[0]) * grid + base[:, 1] + off[1]) * grid \
        + base[:, 2] + off[2]


def _splat(points01: torch.Tensor, normals: torch.Tensor, grid: int):
    """Trilinear scatter of normals (and unit weights) onto a grid^3 field.

    points01: (N, 3) in [0, 1]. The f32 terms are summed in f64. Returns
    (V (3, G, G, G) f64, W (G, G, G) f32)."""
    base, frac = _cell_base(points01, grid)
    dev = points01.device
    f64 = torch.float64
    field = torch.zeros((3, grid ** 3), dtype=f64, device=dev)
    weight = torch.zeros(grid ** 3, dtype=f64, device=dev)
    for off, w in _corner_weights(frac):
        idx = _flat(base, off, grid)
        weight.index_add_(0, idx, w.to(f64))
        for c in range(3):
            field[c].index_add_(0, idx, (normals[:, c] * w).to(f64))
    return (field.view(3, grid, grid, grid),
            weight.to(torch.float32).view(grid, grid, grid))


def _divergence(field: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of the splatted field, per-sample
    spacing, periodic wrap (consistent with the spectral solve; the cloud
    is padded away from the boundary). Real-space divergence needs one
    forward FFT instead of three."""
    div = torch.zeros_like(field[0])
    for ax in range(3):
        f = field[ax]
        div = div + (torch.roll(f, -1, ax) - torch.roll(f, 1, ax)) * 0.5
    return div


def _solve_poisson_from_div(div: torch.Tensor, grid: int,
                            smooth_sigma: float = 1.5) -> torch.Tensor:
    """chi from div(V) via the spectral inverse Laplacian: |k|^2 in f32
    from f32 frequencies, as in the JAX package; the Gaussian, the
    transforms and the spectral product in ``div``'s precision (f64: the
    card's ``exp`` and the CPU's differ in the last bit of an f32); chi
    f32."""
    dev = div.device
    freq = torch.fft.fftfreq(grid, device=dev) * 2 * np.pi
    kx = freq[:, None, None]
    ky = freq[None, :, None]
    kz = (torch.fft.rfftfreq(grid, device=dev) * 2 * np.pi)[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    div_hat = torch.fft.rfftn(div)
    gauss = torch.exp(-0.5 * smooth_sigma ** 2 * k2.to(div.dtype))
    neg_k2 = -torch.clamp_min(k2, 1e-12).to(div.dtype)
    chi_hat = torch.where(k2 > 0, (div_hat * gauss) / neg_k2,
                          torch.zeros((), dtype=div_hat.dtype, device=dev))
    del div_hat, gauss, neg_k2
    return torch.fft.irfftn(chi_hat, s=(grid, grid, grid)).to(torch.float32)


def _trilinear_gather(volume: torch.Tensor, points01: torch.Tensor,
                      grid: int) -> torch.Tensor:
    base, frac = _cell_base(points01, grid)
    out = torch.zeros(points01.shape[0], dtype=torch.float32,
                      device=points01.device)
    for (dx, dy, dz), w in _corner_weights(frac):
        out = out + w * volume[base[:, 0] + dx, base[:, 1] + dy,
                               base[:, 2] + dz]
    return out


def _active_cell_ids(chi: torch.Tensor, grid: int, iso: float,
                     round_f16: bool) -> torch.Tensor:
    """Flat corner-grid ids (int32, C order) of the cells that straddle
    iso: min(corners) < iso <= max(corners), the dense mesher's skip test.

    ``round_f16`` applies f16 rounding to ``chi`` first so the mask agrees
    with the f16 corner values the mesher interpolates: a cell that only
    straddles iso after rounding must not be skipped, or its visited
    neighbour emits boundary triangles with no complement (a crack)."""
    if round_f16:
        chi = chi.to(torch.float16).to(torch.float32)
    cmin = torch.minimum(chi[:-1], chi[1:])
    cmax = torch.maximum(chi[:-1], chi[1:])
    cmin = torch.minimum(cmin[:, :-1], cmin[:, 1:])
    cmax = torch.maximum(cmax[:, :-1], cmax[:, 1:])
    cmin = torch.minimum(cmin[..., :-1], cmin[..., 1:])
    cmax = torch.maximum(cmax[..., :-1], cmax[..., 1:])
    active = ((cmin < iso) & (cmax >= iso)).reshape(-1)
    del cmin, cmax
    ids = torch.nonzero(active).squeeze(1)
    g1 = grid - 1
    ix, rest = ids // (g1 * g1), ids % (g1 * g1)
    iy, iz = rest // g1, rest % g1
    return ((ix * grid + iy) * grid + iz).to(torch.int32)


def _gather_cell_corners(chi: torch.Tensor, cell_ids: torch.Tensor,
                         grid: int, out_f16: bool) -> torch.Tensor:
    """(K,) flat corner-grid cell ids -> (K, 8) corner values in the dense
    mesher's cube-corner order (offsets at stride (grid^2, grid, 1))."""
    offs = torch.tensor([(dx * grid + dy) * grid + dz
                         for dx, dy, dz in _CORNERS], dtype=torch.int64,
                        device=chi.device)
    vals = chi.reshape(-1)[cell_ids.to(torch.int64)[:, None] + offs[None]]
    return vals.to(torch.float16) if out_f16 else vals


def _empty_mesh() -> tuple[np.ndarray, np.ndarray]:
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)


def mesh_indicator(chi: torch.Tensor, iso: float, weight: torch.Tensor,
                   lo: np.ndarray, extent: float,
                   density_percentile: float = 5.0,
                   clock: StageClock | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The meshing stage: indicator ``chi`` (G, G, G) and its ``iso``
    level, splat ``weight`` (G, G, G), and the grid's geometry (world
    ``lo`` of sample 0 and ``extent`` across the grid) ->
    (verts (V, 3) f32, tris (T, 3) int32) on the host.

    Dense: the whole indicator comes to the host and the mesher walks
    every cell. Sparse (``E3D_POISSON_SPARSE``): the straddling cells are
    found on the device, and only their corner values come to the host.
    ``E3D_POISSON_READBACK`` (f16 or f32) sets the precision of what the
    mesher reads; the sparse mask is taken on the same rounding."""
    from .native import marching_tetrahedra, marching_tetrahedra_cells

    clock = clock or StageClock(chi.device)
    grid = chi.shape[0]
    f16 = os.environ.get("E3D_POISSON_READBACK", "f16") == "f16"
    sparse_env = os.environ.get("E3D_POISSON_SPARSE", "auto")
    use_sparse = sparse_env == "1" or (sparse_env == "auto" and grid >= 256)
    spacing = extent / (grid - 1)
    lo = np.asarray(lo, np.float32)
    if use_sparse:
        if grid ** 3 > np.iinfo(np.int32).max:
            # int32 flat cell ids (and the mesher's 64-bit packed edge
            # keys) top out at grid 1290 / depth 10; wrap-around would
            # produce a silently garbage mesh.
            raise ValueError(
                f"grid {grid} overflows the sparse mesher's int32 cell "
                "ids; use grid_depth <= 10")
        with clock.stage("active-cell mask"):
            cell_ids = _active_cell_ids(chi, grid, iso, f16)
        if len(cell_ids) == 0:
            return _empty_mesh()
        with clock.stage("corner gather"):
            vals = _gather_cell_corners(chi, cell_ids, grid, f16)
        with clock.stage("readback", device=False):
            cell_ids = cell_ids.cpu().numpy()
            vals = vals.cpu().numpy().astype(np.float32)
        with clock.stage("mesher", device=False):
            verts, tris = marching_tetrahedra_cells(
                cell_ids, vals, (grid, grid, grid), iso, lo, spacing)
    else:
        with clock.stage("readback", device=False):
            chi_np = (chi.to(torch.float16) if f16 else chi).cpu().numpy()
            chi_np = chi_np.astype(np.float32)
        with clock.stage("mesher", device=False):
            verts, tris = marching_tetrahedra(chi_np, iso, lo, spacing)
    if len(verts) == 0:
        return verts, tris

    if density_percentile > 0:
        with clock.stage("prune", device=False):
            verts01 = ((verts - lo) / extent).astype(np.float32)
            dens = _trilinear_gather(
                weight, torch.from_numpy(verts01).to(weight.device),
                grid).cpu().numpy()
            keep = dens >= np.percentile(dens, density_percentile)
            remap = -np.ones(len(verts), np.int64)
            remap[keep] = np.arange(int(keep.sum()))
            tri_keep = keep[tris].all(axis=1)
            tris = remap[tris[tri_keep]].astype(np.int32)
            verts = verts[keep]
    return verts, tris


def poisson_mesh(points: np.ndarray, normals: np.ndarray,
                 grid_depth: int = 7,
                 smooth_sigma: float = 1.5, density_percentile: float = 5.0,
                 padding: float = 0.05, device: str | torch.device = "cuda",
                 clock: StageClock | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Oriented point cloud (host arrays) -> (verts (V, 3), tris (T, 3))
    on the host.

    The fields live on ``device`` (the card unless the caller asks for
    the CPU). grid_depth: grid = 2^depth per axis (Open3D octree-depth
    analog; the reference uses 9). density_percentile: prune vertices
    whose splat density is below this percentile (the reference removes
    5%). ``clock``: a ``StageClock`` that receives the stage times
    (splat, FFT solve, iso, active-cell mask, corner gather, readback,
    mesher, prune); ``E3D_POISSON_TIMING=1`` prints them.
    """
    from ..core.device import resolve_device

    dev = resolve_device(device)
    timing = os.environ.get("E3D_POISSON_TIMING", "0") == "1"
    clock = clock or StageClock(dev)
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    grid = 1 << grid_depth

    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = float((hi - lo).max()) or 1.0
    lo = lo - padding * extent
    extent = extent * (1 + 2 * padding)
    points01 = (points - lo) / extent

    with clock.stage("splat"):
        pts = torch.from_numpy(points01).to(dev)
        field, weight = _splat(pts, torch.from_numpy(normals).to(dev), grid)
    with clock.stage("FFT solve"):
        div = _divergence(field)
        del field  # free 3 x grid^3 before the FFT allocates its spectra
        chi = _solve_poisson_from_div(div, grid, smooth_sigma)
        del div
    with clock.stage("iso"):
        iso = _trilinear_gather(chi, pts, grid).to(torch.float64).mean()
    iso = float(iso)
    verts, tris = mesh_indicator(chi, iso, weight, lo, extent,
                                 density_percentile, clock)
    if timing:
        for name, ms in clock.result().items():
            print(f"[poisson timing] {name}: {ms:.2f} ms", file=sys.stderr,
                  flush=True)
    return verts, tris
