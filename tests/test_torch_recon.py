"""The port's reconstruction stage against the JAX package's, on the CPU:
the same seeded numpy inputs through ``recon.pointcloud``, ``recon.ply``,
``recon.native`` (the port's own build of ``meshing.cpp``) and
``recon.poisson``; and the port's cv2-semantics readers and resizes
against cv2 itself.

Tolerances: back-projection, poses and transforms 1e-6 (masks and colours
equal); voxel averages equal counts and 1e-6; PLY files byte-equal;
normals and both meshers bit-equal; the Poisson indicator within 1e-5 of
max|chi| and its iso level within 1e-5 relative (the FFTs differ by
rounding); the meshing stage, fed the JAX package's indicator, weights
and iso, bit-equal on the dense and the sparse path at f16 and f32
readback; end to end, vertex counts within 1% and every vertex within
0.05 of a grid spacing of the other mesh, both ways.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

import e3d_tpu  # noqa: F401
from e3d_tpu.recon import native as jnative
from e3d_tpu.recon import ply as jply
from e3d_tpu.recon import pointcloud as jpc
from e3d_tpu.recon import poisson as jpoisson
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch import recon as trecon
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import io as dio
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tresize
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.recon import native as tnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.recon import poisson as tpoisson
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.utils import cbuild

FX, FY, CX, CY = 40.0, 41.5, 31.5, 23.25
GRID_DEPTH = 6


def _sphere(n=20000, seed=3):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)


def _pose(rng):
    q = rng.normal(size=4)
    return (rng.normal(size=3).astype(np.float32),
            (q / np.linalg.norm(q)).astype(np.float32))


@pytest.mark.parametrize("color_dtype", [np.uint8, np.float32])
def test_backproject_pose_transform_match_jax(color_dtype):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 4000, (48, 64), dtype=np.uint16)
    depth[::7, ::5] = 0
    color = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    if color_dtype == np.float32:
        color = color.astype(np.float32) / 255.0
    pos, quat = _pose(rng)
    jmat = np.array(jpc.pose_to_matrix(jnp.asarray(pos), jnp.asarray(quat)))
    tmat = trecon.pose_to_matrix(torch.from_numpy(pos), torch.from_numpy(quat))
    np.testing.assert_allclose(tmat.numpy(), jmat, atol=1e-6, rtol=0)

    jp, jc, jv = jpc.backproject_depth(
        jnp.asarray(depth), FX, FY, CX, CY, color=jnp.asarray(color),
        depth_scale=1000.0, depth_trunc=3.0, transform=jnp.asarray(jmat))
    tp, tc, tv = trecon.backproject_depth(
        torch.from_numpy(depth.astype(np.int32)), FX, FY, CX, CY,
        color=torch.from_numpy(color), depth_scale=1000.0, depth_trunc=3.0,
        transform=torch.from_numpy(jmat))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)

    pts = rng.normal(size=(1000, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(
        trecon.transform_points(torch.from_numpy(pts), tmat).numpy(),
        np.asarray(jpc.transform_points(jnp.asarray(pts), jnp.asarray(jmat))),
        atol=1e-6, rtol=0)


def test_voxel_downsample_matches_jax():
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(20000, 3)) * 0.2).astype(np.float32)
    cols = rng.random((20000, 3)).astype(np.float32)
    nrm = rng.normal(size=(20000, 3)).astype(np.float32)
    want = jpc.voxel_downsample(pts, 0.05, colors=cols, normals=nrm)
    got = trecon.voxel_downsample(torch.from_numpy(pts), 0.05,
                                  colors=torch.from_numpy(cols),
                                  normals=torch.from_numpy(nrm))
    assert len(got[0]) == len(want[0]) < 20000
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    assert trecon.voxel_downsample(torch.from_numpy(pts), 0.05)[1:] == (
        None, None)


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_bytes_equal_and_read_back(binary, tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.random((50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, (20, 3)).astype(np.int32)
    for kw in ({"colors": cols, "normals": nrm}, {"triangles": tris}):
        jpath, tpath = tmp_path / "j.ply", tmp_path / "t.ply"
        jply.write_ply(str(jpath), pts, binary=binary, **kw)
        trecon.write_ply(str(tpath), pts, binary=binary, **kw)
        assert tpath.read_bytes() == jpath.read_bytes()
        back = trecon.read_ply(str(tpath))
        np.testing.assert_allclose(back["points"], pts, atol=1e-6)
        if "triangles" in kw:
            np.testing.assert_array_equal(back["triangles"], tris)
        else:
            np.testing.assert_allclose(back["normals"], nrm, atol=1e-6)
            np.testing.assert_allclose(
                back["colors"], (np.clip(cols, 0, 1) * 255).astype(
                    np.uint8) / 255.0, atol=1e-6)


def test_native_kernels_bit_equal_to_jax():
    pts, _ = _sphere(4000, seed=5)
    pts = pts * np.float32(0.7) + np.float32(0.1)
    view = np.zeros(3, np.float32)
    np.testing.assert_array_equal(
        tnative.estimate_normals(pts, 0.2, 30, orient_toward=view),
        jnative.estimate_normals(pts, 0.2, 30, orient_toward=view))
    # The port builds its own copy of the source into build/host/.
    assert cbuild.library_path("host/meshing").exists()

    g = np.mgrid[0:20, 0:18, 0:16].astype(np.float32)
    field = np.sqrt(((g - 8.3) ** 2).sum(0)) + np.random.default_rng(6) \
        .random((20, 18, 16)).astype(np.float32) * 0.1
    origin = np.array([0.5, -1.0, 2.0], np.float32)
    for got, want in zip(tnative.marching_tetrahedra(field, 5.0, origin, 0.1),
                         jnative.marching_tetrahedra(field, 5.0, origin,
                                                     0.1)):
        assert len(want) > 100
        np.testing.assert_array_equal(got, want)
    ids = np.array([(ix * 18 + iy) * 16 + iz for ix in range(19)
                    for iy in range(17) for iz in range(15)], np.int32)
    flat = field.reshape(-1)
    offs = [(dx * 18 + dy) * 16 + dz for dx, dy, dz in tpoisson._CORNERS]
    vals = flat[ids[:, None] + np.asarray(offs)[None]]
    for got, want in zip(
            tnative.marching_tetrahedra_cells(ids, vals, field.shape, 5.0,
                                              origin, 0.1),
            jnative.marching_tetrahedra_cells(ids, vals, field.shape, 5.0,
                                              origin, 0.1)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"\(3, 8\)"):
        tnative.marching_tetrahedra_cells(ids[:3], vals[:2], field.shape,
                                          5.0, origin, 0.1)


def _jax_indicator(points, normals, grid_depth):
    """The JAX package's chi, weight and iso, as its ``poisson_mesh``
    computes them, with the grid geometry."""
    grid = 1 << grid_depth
    lo, hi = points.min(axis=0), points.max(axis=0)
    extent = float((hi - lo).max())
    lo = lo - 0.05 * extent
    extent = extent * 1.1
    p01 = (points - lo) / extent
    nb = jpoisson._bucket(len(p01))
    pts = jnp.asarray(jpoisson._pad_rows(p01.astype(np.float32), nb))
    field, weight = jpoisson._splat(
        pts, jnp.asarray(jpoisson._pad_rows(normals, nb)), grid)
    chi = jpoisson._solve_poisson_from_div(
        jpoisson._divergence(field, grid), grid, 1.5)
    iso = float(jpoisson._masked_mean_gather(chi, pts, grid, len(p01)))
    return np.asarray(chi), np.asarray(weight), iso, lo, extent, p01


def test_indicator_matches_jax():
    points, normals = _sphere()
    chi, _, iso, _, _, p01 = _jax_indicator(points, normals, GRID_DEPTH)
    grid = 1 << GRID_DEPTH
    pts = torch.from_numpy(p01)
    field, weight = tpoisson._splat(pts, torch.from_numpy(normals), grid)
    tchi = tpoisson._solve_poisson_from_div(tpoisson._divergence(field),
                                            grid, 1.5)
    tiso = float(tpoisson._trilinear_gather(tchi, pts, grid).mean())
    scale = np.abs(chi).max()
    assert np.abs(tchi.numpy() - chi).max() <= 1e-5 * scale
    assert abs(tiso - iso) <= 1e-5 * abs(iso)


@pytest.fixture(scope="module")
def sphere_indicator():
    points, normals = _sphere()
    return points, normals, _jax_indicator(points, normals, GRID_DEPTH)


@pytest.mark.parametrize("readback", ["f16", "f32"])
@pytest.mark.parametrize("sparse", ["0", "1"])
def test_mesh_stage_bit_equal_on_jax_indicator(sparse, readback,
                                               sphere_indicator,
                                               monkeypatch):
    points, normals, (chi, weight, iso, lo, extent, _) = sphere_indicator
    monkeypatch.setenv("E3D_POISSON_SPARSE", sparse)
    monkeypatch.setenv("E3D_POISSON_READBACK", readback)
    want = jpoisson.poisson_mesh(points, normals, grid_depth=GRID_DEPTH)
    got = tpoisson.mesh_indicator(torch.from_numpy(chi), iso,
                                  torch.from_numpy(weight), lo, extent)
    assert len(want[0]) > 1000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def assert_meshes_match(got, want, spacing):
    """Vertex counts within 1%; every vertex within 0.05 of a grid spacing
    of the other mesh, both ways."""
    (gv, _), (wv, _) = got, want
    assert abs(len(gv) - len(wv)) <= 0.01 * len(wv), (len(gv), len(wv))
    assert cKDTree(wv).query(gv)[0].max() <= 0.05 * spacing
    assert cKDTree(gv).query(wv)[0].max() <= 0.05 * spacing


def test_poisson_mesh_end_to_end_matches_jax(sphere_indicator):
    points, normals, (_, _, _, _, extent, _) = sphere_indicator
    want = jpoisson.poisson_mesh(points, normals, grid_depth=GRID_DEPTH)
    got = tpoisson.poisson_mesh(points, normals, grid_depth=GRID_DEPTH,
                                device="cpu")
    assert len(want[0]) > 1000
    assert_meshes_match(got, want, extent / ((1 << GRID_DEPTH) - 1))


@pytest.mark.parametrize("readback", ["f16", "f32"])
def test_port_sparse_path_equals_dense(readback, monkeypatch):
    """As the JAX package's ``test_recon_geometric.py``: single-threaded,
    the sparse path (straddle mask and corner gather on the device, the
    sparse mesher) walks the dense path's cells in its order, so the
    welded meshes are bit-equal; the f16 mask is taken on f16 values."""
    points, normals = _sphere(seed=4)
    monkeypatch.setenv("E3D_MESH_THREADS", "1")
    monkeypatch.setenv("E3D_POISSON_READBACK", readback)
    monkeypatch.setenv("E3D_POISSON_SPARSE", "0")
    vd, td = tpoisson.poisson_mesh(points, normals, grid_depth=GRID_DEPTH,
                                   device="cpu")
    monkeypatch.setenv("E3D_POISSON_SPARSE", "1")
    vs, ts = tpoisson.poisson_mesh(points, normals, grid_depth=GRID_DEPTH,
                                   device="cpu")
    assert len(vd) > 1000
    np.testing.assert_array_equal(vs, vd)
    np.testing.assert_array_equal(ts, td)


def test_stage_clock_times_every_poisson_stage(monkeypatch, capsys):
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.recon.stages import StageClock

    points, normals = _sphere(3000, seed=8)
    monkeypatch.setenv("E3D_POISSON_TIMING", "1")
    monkeypatch.setenv("E3D_POISSON_SPARSE", "1")
    clock = StageClock("cpu")
    tpoisson.poisson_mesh(points, normals, grid_depth=5, device="cpu",
                          clock=clock)
    stages = clock.result()
    assert list(stages) == ["splat", "FFT solve", "iso", "active-cell mask",
                            "corner gather", "readback", "mesher", "prune"]
    assert all(ms >= 0 for ms in stages.values())
    assert "[poisson timing] mesher:" in capsys.readouterr().err


R_CYL = 1.0


def test_cylinder_golden_on_the_port():
    """The JAX package's geometric golden (``test_recon_geometric.py``)
    through the port: a camera down the axis of a cylinder of radius 1 m,
    exact z-depth, fused with its poses; the points lie on the surface and
    the mesh is a tube of radius ~1."""
    hw, f, c = 64, 40.0, 31.5
    v, u = np.mgrid[0:hw, 0:hw].astype(np.float64)
    radial = np.maximum(np.hypot((u - c) / f, (v - c) / f), 1e-6)
    depth_mm = np.clip(R_CYL / radial * 1000.0, 0, 65535).astype(np.uint16)
    pts = []
    for z0 in np.linspace(0.0, 2.0, 9):
        mat = trecon.pose_to_matrix(torch.tensor([0.0, 0.0, z0]),
                                    torch.tensor([0.0, 0.0, 0.0, 1.0]))
        p, _, valid = trecon.backproject_depth(
            torch.from_numpy(depth_mm.astype(np.int32)), f, f, c, c,
            transform=mat)
        pts.append(p[valid])
    points = torch.cat(pts)
    assert len(points) > 10000
    radii = torch.linalg.vector_norm(points[:, :2], dim=1).numpy()
    np.testing.assert_allclose(radii, R_CYL, atol=2e-3)
    pts_ds = trecon.voxel_downsample(points, 0.02)[0].numpy()
    axis = np.stack([np.zeros(len(pts_ds)), np.zeros(len(pts_ds)),
                     pts_ds[:, 2]], axis=1).astype(np.float32)
    normals = -tnative.estimate_normals(pts_ds, radius=0.15, max_nn=30,
                                        orient_toward=axis)
    verts, tris = tpoisson.poisson_mesh(pts_ds, normals, grid_depth=6,
                                        density_percentile=2.0, device="cpu")
    assert len(verts) > 500 and len(tris) > 500
    zmid = (verts[:, 2] > 0.8) & (verts[:, 2] < 2.2)
    assert zmid.sum() > 100
    radii = np.linalg.norm(verts[zmid][:, :2], axis=1)
    assert abs(np.median(radii) - R_CYL) < 0.12, np.median(radii)


_PNG_KINDS = {
    "rgb8": ((33, 17, 3), np.uint8), "rgb16": ((9, 13, 3), np.uint16),
    "gray8": ((9, 13), np.uint8), "gray16": ((9, 13), np.uint16),
    "rgba8": ((9, 13, 4), np.uint8),
}


@pytest.mark.parametrize("kind", [*_PNG_KINDS, "gray_alpha8"])
def test_readers_are_cv2_imread(kind, tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / f"{kind}.png")
    if kind == "gray_alpha8":
        Image.fromarray(rng.integers(0, 256, (16, 16, 2), dtype=np.uint8),
                        "LA").save(path)
    else:
        shape, dtype = _PNG_KINDS[kind]
        cv2.imwrite(path, rng.integers(0, np.iinfo(dtype).max + 1, shape,
                                       dtype=dtype))
    for name, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                       ("grayscale", cv2.IMREAD_GRAYSCALE),
                       ("anydepth", cv2.IMREAD_ANYDEPTH)):
        want = cv2.imread(path, flag)
        got = getattr(dio, f"imread_{name}")(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("sizes", [((64, 64), (48, 48)),
                                   ((475, 1000), (475, 475)),
                                   ((475, 475), (518, 518)),
                                   ((7, 9), (21, 4)), ((64, 64), (32, 32))])
def test_resizes_are_cv2s(sizes):
    (h, w), (oh, ow) = sizes
    rng = np.random.default_rng(h * w)
    img = rng.random((h, w), dtype=np.float32)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = tresize.resize_linear(torch.from_numpy(img), (oh, ow)).numpy()
    # cv2 blends with fused multiply-adds where its build has them: an
    # ulp or two of the [0, 1] values.
    np.testing.assert_allclose(got, want, atol=3e-7, rtol=0)
    mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
    np.testing.assert_array_equal(
        tresize.resize_nearest(torch.from_numpy(mask), (oh, ow),
                               channels_last=False).numpy(),
        cv2.resize(mask, (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("reader", ["unchanged", "grayscale", "anydepth"])
def test_readers_refuse_what_they_do_not_read(reader, tmp_path):
    path = tmp_path / "x.bmp"
    path.write_bytes(b"BM")
    with pytest.raises(ValueError, match="PNG"):
        getattr(dio, f"imread_{reader}")(str(path))
