"""The port's data slice against the JAX package's: fixtures, datasets,
the combined dataset's host resize, and the prefetching loader.

- The fixtures draw from one seed in the same order, so the port's trees
  (written by its own PNG/TIFF writers) hold the JAX package's pixels
  (written by PIL and cv2) and split lists, exactly.
- The datasets read one tree into the same sample dicts: decoded arrays
  exactly, host-resized [0, 1] floats within f32 ``atol`` 1e-6 (both sides
  run the same float32 einsums over the same weights; only the order of
  summation inside numpy may differ).
- The loader walks the same batch order from the same shuffle seed.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

import e3d_tpu  # noqa: F401
from e3d_tpu.data import io as jio
from e3d_tpu.data import synthetic as jsyn
from e3d_tpu.data.c3vd import C3VDDataset as JC3VD
from e3d_tpu.data.combined import CombinedDataModule as JCombinedDM
from e3d_tpu.data.loader import PrefetchLoader as JLoader
from e3d_tpu.data.simcol import SimColDataset as JSimCol
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import io as tio
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import synthetic as tsyn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.c3vd import C3VDDataset as TC3VD
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.combined import CombinedDataModule as TCombinedDM
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.loader import PrefetchLoader as TLoader
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.simcol import SimColDataset as TSimCol
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.simcol import SimColDataModule as TSimColDM

HOST_RESIZE_ATOL = 1e-6


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    out = {}
    for side, syn in (("jax", jsyn), ("port", tsyn)):
        out[side] = {
            "simcol": syn.make_simcol_fixture(str(root / side / "simcol"),
                                              n_procedures=3,
                                              frames_per_proc=3, hw=32,
                                              seed=7),
            "c3vd": syn.make_c3vd_fixture(str(root / side / "c3vd"),
                                          n_scenes=2, frames=3, hw=40,
                                          seed=8)}
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind", ["simcol", "c3vd"])
def test_fixtures_equal_the_jax_fixtures(trees, kind):
    jroot, troot = trees["jax"][kind], trees["port"][kind]
    names = _files(jroot)
    assert names == _files(troot) and names
    for name in names:
        j, t = os.path.join(jroot, name), os.path.join(troot, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(t)),
                                          np.asarray(Image.open(j)))
        elif name.endswith(".tiff"):
            np.testing.assert_array_equal(
                cv2.imread(t, cv2.IMREAD_UNCHANGED),
                cv2.imread(j, cv2.IMREAD_UNCHANGED))
        else:  # split lists, poses, intrinsics
            with open(j, "rb") as fj, open(t, "rb") as ft:
                assert fj.read() == ft.read(), name


def _assert_same_sample(got, want, atol=0.0):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_allclose(got[key], value, atol=atol, rtol=0,
                                       err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("host_resize", [False, True],
                         ids=["raw", "host_resize"])
@pytest.mark.parametrize("mode", ["Train", "Val", "Test"])
def test_simcol_samples_match(trees, mode, host_resize):
    root = trees["port"]["simcol"]
    split = {"Train": "train", "Val": "val", "Test": "test"}[mode]
    args = (root, os.path.join(root, f"{split}.txt"), 24, mode)
    jds = JSimCol(*args, host_resize=host_resize)
    tds = TSimCol(*args, host_resize=host_resize)
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        _assert_same_sample(tds[i], jds[i], HOST_RESIZE_ATOL)


@pytest.mark.parametrize("host_resize", [False, True],
                         ids=["raw", "host_resize"])
def test_c3vd_samples_match(trees, host_resize):
    root = trees["port"]["c3vd"]
    args = (root, os.path.join(root, "train.txt"), 24, "Train")
    jds = JC3VD(*args, host_resize=host_resize)
    tds = TC3VD(*args, host_resize=host_resize)
    assert len(tds) == len(jds) == 6
    for i in range(len(jds)):
        _assert_same_sample(tds[i], jds[i], HOST_RESIZE_ATOL)


def test_combined_samples_match(trees):
    s, c = trees["port"]["simcol"], trees["port"]["c3vd"]
    kwargs = dict(simcol_data_dir=s,
                  simcol_train_list=os.path.join(s, "train.txt"),
                  simcol_val_list=os.path.join(s, "val.txt"),
                  simcol_test_list=os.path.join(s, "test.txt"),
                  c3vd_data_dir=c,
                  c3vd_train_list=os.path.join(c, "train.txt"),
                  c3vd_val_list=os.path.join(c, "val.txt"),
                  batch_size=4, num_workers=2, size=24)
    jdm, tdm = JCombinedDM(**kwargs), TCombinedDM(**kwargs)
    jdm.setup(None)
    tdm.setup(None)
    for split in ("train_dataset", "val_dataset", "test_dataset"):
        jds, tds = getattr(jdm, split), getattr(tdm, split)
        assert len(tds) == len(jds) > 0
        sources = []
        for i in range(len(jds)):
            want = jds[i]
            _assert_same_sample(tds[i], want, HOST_RESIZE_ATOL)
            sources.append(want["source"])
        assert set(sources) == {0, 1}


def test_c3vd_color_matches_cv2_on_16bit_and_gray(tmp_path):
    """``decode_c3vd_color`` reads as cv2 does, then BGR->RGB: 16-bit
    colour cut by ``(img / 256).astype(np.uint8)``, gray replicated."""
    rng = np.random.default_rng(9)
    rgb16 = rng.integers(0, 65536, (20, 30, 3), dtype=np.uint16)
    gray = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    assert cv2.imwrite(str(tmp_path / "c16.png"), rgb16)
    assert cv2.imwrite(str(tmp_path / "g.png"), gray)
    for name in ("c16.png", "g.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(tio.decode_c3vd_color(path),
                                      jio.decode_c3vd_color(path))


def test_depth16_and_rgb_decode_match(trees):
    root = trees["port"]["simcol"]
    depth, rgb = tio.load_frames(os.path.join(
        root, "SyntheticColon_I", "Frames_S1"))
    assert (depth, rgb) == jio.load_frames(os.path.join(
        root, "SyntheticColon_I", "Frames_S1"))
    np.testing.assert_array_equal(tio.decode_depth16_png(depth[0]),
                                  jio.decode_depth16_png(depth[0]))
    np.testing.assert_array_equal(tio.decode_rgb(rgb[0]),
                                  jio.decode_rgb(rgb[0]))


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64), "id": f"s{i}", "k": i}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_loader_walks_the_jax_order(shuffle, drop_last):
    ds = _Indexed(23)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_threads=3, seed=11)
    jl = JLoader(ds, process_index=0, process_count=1, **kw)
    tl = TLoader(ds, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):  # two epochs: the seed advances with the epoch
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t["x"], j["x"])
            np.testing.assert_array_equal(t["k"], j["k"])
            assert t["id"] == j["id"]


def test_loader_shards_by_rank():
    ds = _Indexed(8)
    full = [b["k"] for b in TLoader(ds, batch_size=4, shuffle=True, seed=3)]
    halves = [[b["k"] for b in TLoader(ds, batch_size=4, shuffle=True,
                                       seed=3, rank=r, world=2)]
              for r in (0, 1)]
    for b, lo, hi in zip(full, *halves):
        np.testing.assert_array_equal(np.concatenate([lo, hi]), b)
    with pytest.raises(ValueError, match="rank 2 outside a world of 2"):
        TLoader(ds, batch_size=4, rank=2, world=2)


def test_simcol_datamodule_loaders(trees):
    root = trees["port"]["simcol"]
    dm = TSimColDM(root, os.path.join(root, "train.txt"),
                   os.path.join(root, "val.txt"),
                   os.path.join(root, "test.txt"), batch_size=2,
                   num_workers=2, size=24)
    dm.setup(None)
    batch = next(iter(dm.train_loader()))
    assert batch["image"].shape == (2, 32, 32, 3)
    assert batch["depth"].dtype == np.uint16
    assert batch["ds_type"] == ["simcol", "simcol"]
