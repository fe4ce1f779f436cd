"""The port's reconstruction CLIs and offline tools against the JAX
package's, on the CPU (``--device cpu``), on one ``make_simcol_fixture``
tree at 48 px.

The tree holds, beside 16-bit depth predictions, colourised 3-channel
8-bit predictions, a 16-bit RGB and an RGBA one, and a trajectory whose
predictions have another size than their ground truth, so that cv2's
channel order, its RGB->gray and its ``INTER_LINEAR`` / ``INTER_NEAREST``
resizes are all exercised.

Tolerances: the fused cloud 1e-6 (equal counts, colours equal); the mesh
by the count and distance rule of ``tests/test_torch_recon.py``; the
per-frame clouds of ``pointcloud_model`` 1e-6 (the JAX CLI's model and
``infer_image`` are replaced by the port's, so both back-project the same
depth); the tools' metrics 1e-5 relative (f32 reductions in other
orders); the extracted frames byte-equal.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import e3d_tpu  # noqa: F401
from e3d_tpu.cli import calc_metrics as jcalc_metrics
from e3d_tpu.cli import calc_stats as jcalc_stats
from e3d_tpu.cli import eval_depth_offline as jeval
from e3d_tpu.cli import pointcloud as jpointcloud
from e3d_tpu.cli import pointcloud_model as jpointcloud_model
from e3d_tpu.cli import video_to_images as jvideo_to_images
from e3d_tpu.models import convert as jconvert
from e3d_tpu.models import depth_anything as jda
from e3d_tpu.recon import read_ply
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import calc_metrics as tcalc_metrics
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import calc_stats as tcalc_stats
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import eval_depth_offline as teval
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import pointcloud as tpointcloud
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import pointcloud_model as tpointcloud_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import video_to_images as tvideo_to_images
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import native as tmedia
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import convert as tconvert
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda

HW = 48
FRAMES = 4
MESH_DEPTH = 5


def _prediction(kind: str, rng, hw=(HW, HW)):
    """A prediction PNG's pixels (cv2's channel order) by kind."""
    if kind == "depth16":
        return rng.integers(300, 2900, hw, dtype=np.uint16)
    if kind == "colour":  # a colourised rendering: unequal channels
        return rng.integers(1, 256, (*hw, 3), dtype=np.uint8)
    if kind == "rgb16":
        return rng.integers(300, 2900, (*hw, 3), dtype=np.uint16)
    return rng.integers(1, 256, (*hw, 4), dtype=np.uint8)  # rgba


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``make_simcol_fixture`` at 48 px (10 procedures of 4 frames, their
    poses, ``UnityCam/cam.txt`` and split lists) with predictions for
    Frames_S5 (every kind, the GT's size) and Frames_S10 (another size);
    plus a 6-frame MJPEG AVI."""
    root = tmp_path_factory.mktemp("recon_cli")
    make_simcol_fixture(str(root), n_procedures=10, frames_per_proc=FRAMES,
                        hw=HW, seed=0)
    rng = np.random.default_rng(0)
    kinds = {"S5": ["colour", "depth16", "rgb16", "rgba"],
             "S10": ["colour", "depth16", "colour", "depth16"]}
    for proc, pred_kinds in kinds.items():
        op = root / "SyntheticColon_I" / f"Frames_{proc}_OP"
        op.mkdir()
        pred_hw = (HW, HW) if proc == "S5" else (40, 56)
        for i, kind in enumerate(pred_kinds):
            cv2.imwrite(str(op / f"Depth_{i:04d}.png"),
                        _prediction(kind, rng, pred_hw))
    with tmedia.VideoWriter(str(root / "clip.avi"), 64, 48, fps=10.0) as w:
        for i in range(6):
            w.write_rgb(np.random.default_rng(i).integers(
                0, 256, (48, 64, 3), dtype=np.uint8), quality=90)
    return root


def assert_meshes_match(got, want, spacing):
    """Vertex counts within 1%; every vertex within 0.05 of a grid spacing
    of the other mesh, both ways."""
    assert abs(len(got) - len(want)) <= 0.01 * len(want), (len(got),
                                                          len(want))
    assert cKDTree(want).query(got)[0].max() <= 0.05 * spacing
    assert cKDTree(got).query(want)[0].max() <= 0.05 * spacing


def _cloud(path):
    pc = read_ply(str(path))
    return pc["points"], pc["colors"]


def test_pointcloud_matches_the_jax_cli(tree, tmp_path):
    args = ["-i", str(tree), "--mesh-depth", str(MESH_DEPTH),
            "--voxel-size", "0.002"]
    jpointcloud.main(args + ["-o", str(tmp_path / "j")])
    result = tpointcloud.main(args + ["-o", str(tmp_path / "t"),
                                      "--device", "cpu"])
    jp, jc = _cloud(tmp_path / "j" / "combined_point_cloud.ply")
    tp, tc = _cloud(tmp_path / "t" / "combined_point_cloud.ply")
    assert tp.shape == jp.shape and len(jp) > 1000
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tc, jc)
    assert result["frames"] == 2 * FRAMES
    assert result["points_after"] == len(tp)
    assert {"backprojection", "voxel grid", "normals", "splat",
            "FFT solve", "mesher"} <= set(result["stages"])

    jmesh = read_ply(str(tmp_path / "j" / "combined_mesh.ply"))
    tmesh = read_ply(str(tmp_path / "t" / "combined_mesh.ply"))
    assert len(jmesh["points"]) > 100 and result["verts"] == len(
        tmesh["points"])
    extent = (tp.max(0) - tp.min(0)).max() * 1.1
    assert_meshes_match(tmesh["points"], jmesh["points"],
                        extent / ((1 << MESH_DEPTH) - 1))


def test_pointcloud_model_matches_the_jax_cli(tree, tmp_path, monkeypatch):
    """The JAX CLI's frame, cam and back-projection logic is the oracle;
    its model is replaced by the port's (f32, vitt), so both CLIs
    back-project the same depth maps."""
    model = tconvert.load_or_init_depth_model("vitt", 20.0, None,
                                              device="cpu",
                                              dtype=torch.float32)
    monkeypatch.setattr(jconvert, "load_or_init_depth_params",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(jda, "infer_image",
                        lambda _m, _p, raw, size: tda.infer_image(
                            model, raw, size))
    monkeypatch.setattr(tconvert, "load_or_init_depth_model",
                        lambda *a, **k: model)
    args = ["--encoder", "vitt", "-i", str(tree), "--input-size", "42",
            "--max-frames", "3"]
    jpointcloud_model.main(args + ["-o", str(tmp_path / "j")])
    result = tpointcloud_model.main(args + ["-o", str(tmp_path / "t"),
                                            "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert result["frames"] == 3 and len(names) == 3
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        jp, jc = _cloud(tmp_path / "j" / name)
        tp, tc = _cloud(tmp_path / "t" / name)
        assert tp.shape == jp.shape and len(jp) > 100
        np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("flags", [["--int8"], ["--token-merge", "0.3"]])
def test_pointcloud_model_refuses_speed_dials(tree, flags, tmp_path):
    """``--int8`` and ``--token-merge``, refused until the port had them,
    now run: a cloud per frame, finite and within max depth + 1 of the
    camera (the CLI's truncation), moved away from the default run's.
    ``--int8-calib`` stays unknown here, as in the JAX CLI."""
    args = ["-i", str(tree), "--encoder", "vitt", "--input-size", "42",
            "--max-frames", "2", "--device", "cpu"]
    tpointcloud_model.main(args + ["-o", str(tmp_path / "default")])
    result = tpointcloud_model.main(args + ["-o", str(tmp_path / "dial")]
                                    + flags)
    names = sorted(os.listdir(tmp_path / "dial"))
    assert result["frames"] == 2 and names == sorted(
        os.listdir(tmp_path / "default"))
    moved = False
    for name in names:
        points, _ = _cloud(tmp_path / "dial" / name)
        base, _ = _cloud(tmp_path / "default" / name)
        assert len(points) > 100 and np.isfinite(points).all()
        assert points[:, 2].min() >= 0.0 and points[:, 2].max() <= 21.0
        moved |= points.shape != base.shape or not np.array_equal(points,
                                                                   base)
    assert moved
    with pytest.raises(SystemExit):  # no --int8-calib: the JAX CLI has none
        tpointcloud_model.main(["-i", str(tree), "-o", "o",
                                "--int8-calib", "1"])


def _assert_close(got: dict, want: dict, rtol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_eval_depth_offline_matches_the_jax_cli(tree, capsys):
    jeval.main(["--input-path", str(tree), "--no-strict"])
    jtext = capsys.readouterr().out
    result = teval.main(["--input-path", str(tree), "--no-strict",
                         "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == jtext.splitlines()[0]
    trajs = ["SyntheticColon_I/Frames_S5_OP", "SyntheticColon_I/Frames_S10_OP"]
    assert list(result) == trajs + ["overall"]
    for traj in trajs:
        rows = []
        for path in sorted((tree / traj).glob("Depth*.png")):
            gt = str(tree / traj[:-3] / path.name)
            rows.append(jeval.eval_depth(*jeval.load_depth(str(path), gt, 0)))
        _assert_close(result[traj], dict(zip(teval.METRICS,
                                             np.mean(rows, axis=0))))
    # The strict run refuses the incomplete trajectories, as the JAX CLI.
    with pytest.raises(AssertionError):
        teval.main(["--input-path", str(tree), "--device", "cpu"])


def test_calc_metrics_matches_the_jax_cli(tree, tmp_path, capsys):
    # Frames_S5 only: a prediction of another size than its ground truth
    # (Frames_S10) stops both CLIs, as it stops the reference's.
    root = tmp_path / "same_size"
    colon = root / "SyntheticColon_I"
    colon.mkdir(parents=True)
    for name in ("Frames_S5", "Frames_S5_OP"):
        (colon / name).symlink_to(tree / "SyntheticColon_I" / name)
    jcalc_metrics.main(["--dataset-root", str(root)])
    jtext = capsys.readouterr().out
    result = tcalc_metrics.main(["--dataset-root", str(root),
                                 "--device", "cpu"])
    ttext = capsys.readouterr().out
    assert [ln.split(":")[0].split("=")[0] for ln in ttext.splitlines()] == \
        [ln.split(":")[0].split("=")[0] for ln in jtext.splitlines()]
    want = jcalc_metrics.process_scene(str(colon / "Frames_S5"),
                                       str(colon / "Frames_S5_OP"))
    _assert_close(result["SyntheticColon_I"]["Frames_S5"], want)
    _assert_close(result["overall"], want)
    with pytest.raises(ValueError):
        jcalc_metrics.main(["--dataset-root", str(tree)])
    with pytest.raises(RuntimeError):
        tcalc_metrics.main(["--dataset-root", str(tree), "--device", "cpu"])


def test_calc_stats_matches_the_jax_cli(tree, capsys):
    args = ["--data-dir", str(tree), "--train-list", str(tree / "train.txt"),
            "--size", "28", "--batch-size", "3", "--num-workers", "2"]
    jcalc_stats.main(args)
    jtext = capsys.readouterr().out.splitlines()
    result = tcalc_stats.main(args + ["--device", "cpu"])
    ttext = capsys.readouterr().out.splitlines()
    want_mean, want_std = (np.array(line.split("[")[2].rstrip("]").split(),
                                    float) for line in jtext[:2])
    np.testing.assert_allclose(result["rgb_mean"], want_mean, rtol=1e-5)
    np.testing.assert_allclose(result["rgb_std"], want_std, rtol=1e-5)
    assert ttext[2].split("(")[1] == jtext[2].split("(")[1]  # valid px
    d_mean, d_std = (float(x) for x in jtext[2].split()[3:6:2])
    assert result["depth_mean"] == pytest.approx(d_mean, abs=1e-6)
    assert result["depth_std"] == pytest.approx(d_std, abs=1e-6)


def test_video_to_images_matches_the_jax_cli(tree, tmp_path):
    config = tmp_path / "cfg.yaml"
    config.write_text("video_path: ''\noutput_dir: ''\nfps: null  # native\n"
                      "start_time: 0.1\nend_time: null\n"
                      "crop:\n  x: 8\n  y: 4\n  width: 40\n  height: 30\n")
    outs = {}
    for name, main in (("j", jvideo_to_images.main),
                       ("t", tvideo_to_images.main)):
        outs[name] = tmp_path / name
        main(["--config", str(config), "--video_path", str(tree / "clip.avi"),
              "--output_dir", str(outs[name])])
    names = sorted(os.listdir(outs["j"]))
    assert names == sorted(os.listdir(outs["t"])) and len(names) == 5
    for n in names:
        assert (outs["t"] / n).read_bytes() == (outs["j"] / n).read_bytes()
    assert tvideo_to_images.main(["--video_path", str(tree / "clip.avi"),
                                  "--output_dir", str(tmp_path / "x"),
                                  "--test", "--test_frames", "2"]) == 2


def test_cli_defaults_to_the_card(tree, tmp_path):
    """Asked for nothing, the new CLIs run on the card, and without one
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main, args in (
            (tpointcloud.main, ["-i", str(tree), "-o", str(tmp_path)]),
            (teval.main, ["--input-path", str(tree), "--no-strict"]),
            (tcalc_metrics.main, ["--dataset-root", str(tree)]),
            (tpointcloud_model.main, ["-i", str(tree), "-o", str(tmp_path), "--encoder", "vitt"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
