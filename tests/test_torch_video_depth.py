"""The port's video -> depth-video entry point against the JAX package's,
on the CPU: the same vitt ``.pth`` (``synthetic_dav2_state_dict``), the
same 6-frame 64x64 MJPEG AVI, ``--input-size 56``.

Both sides share the JPEG codec (the same C++ source and flags) and the
colormap tables, so the rendered frames differ only through the depth
maps, which both compute in bf16 with roundings in different places. The
per-frame min-max stretch to 0..255 magnifies those differences, and the
JPEG re-encoding spreads them over 8x8 blocks: measured, the decoded
frames differ by 1.4 levels of 255 on average (0.8 in grayscale), 15 at
most. The bound is 4 levels on average. A wiring fault is far outside it:
the port's own random init in place of the checkpoint moves the frames by
tens of levels, which the test checks too, so the bound discriminates.
"""

import os

import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.cli import video_depth as jvd
from e3d_tpu.media import native as jnative
from e3d_tpu.models.convert import synthetic_dav2_state_dict
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import convert_video as tconvert_video
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import video_depth as tvd
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.checkpoint import CheckpointManager
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import colormap as tcolormap
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import native as tnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import load_or_init_depth_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model

MEAN_TOL = 4.0  # levels of 255, see the module docstring


def _smooth_rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.standard_normal((h, w, 3)), axis=1),
                    axis=0)
    return ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_depth")
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_dav2_state_dict("vitt", 0).items()},
               root / "vitt.pth")
    with tnative.VideoWriter(str(root / "in.avi"), 64, 64, fps=10.0) as w:
        for i in range(6):
            w.write_rgb(_smooth_rgb(64, 64, i), quality=90)
    return root


def _args(root, out, *extra, weights=True):
    args = ["--encoder", "vitt", "-i", str(root / "in.avi"), "-o", out,
            "--input-size", "56", "--batch-size", "4", *extra]
    return args + (["--load-from", str(root / "vitt.pth")] if weights
                   else [])


def _decoded(path):
    with jnative.VideoReader(path) as r:
        return r.fps, np.stack([r.frame_rgb(i).astype(np.int64)
                                for i in range(r.num_frames)])


@pytest.mark.parametrize("extra", [[], ["--grayscale"],
                                   ["--side-by-side", "--quality", "92"]],
                         ids=["spectral", "grayscale", "side_by_side"])
def test_port_matches_the_jax_cli(fixture_dir, extra):
    jout = str(fixture_dir / f"jax{len(extra)}.mp4")
    tout = str(fixture_dir / f"port{len(extra)}.mp4")
    jvd.main(_args(fixture_dir, jout, *extra))
    result = tvd.main(_args(fixture_dir, tout, *extra, "--device", "cpu"))
    (jfps, want), (tfps, got) = _decoded(jout), _decoded(tout)
    width = 64 + 50 + 64 if "--side-by-side" in extra else 64
    assert got.shape == want.shape == (6, 64, width, 3)
    assert tfps == jfps == 10.0
    assert result["frames"] == 6 and result["engine"]["completed"] == 6
    assert result["engine"]["failed"] == 0
    assert np.abs(got - want).mean() <= MEAN_TOL


def test_the_bound_tells_weights_apart(fixture_dir):
    jout, tout = str(fixture_dir / "jax_w.avi"), str(fixture_dir / "rnd.avi")
    jvd.main(_args(fixture_dir, jout))
    tvd.main(_args(fixture_dir, tout, "--device", "cpu", weights=False))
    assert np.abs(_decoded(tout)[1] - _decoded(jout)[1]).mean() > \
        3 * MEAN_TOL


def test_output_frames_are_the_rendered_depths(fixture_dir):
    """Each output frame is, byte for byte, the JPEG of the Spectral
    rendering of the depth map ``on_depth`` saw for that input frame."""
    out = str(fixture_dir / "hook.avi")
    depths = {}
    tvd.main(_args(fixture_dir, out, "--device", "cpu"),
             on_depth=depths.__setitem__)
    assert sorted(depths) == list(range(6))
    with tnative.VideoReader(out) as r:
        for i in range(6):
            assert depths[i].shape == (64, 64)
            assert depths[i].dtype == np.float32
            assert np.isfinite(depths[i]).all()
            assert r.frame_bytes(i) == tnative.encode_jpeg(
                tcolormap.colorize_depth(depths[i], bgr=False), 90)


def test_frame_window_and_fps(fixture_dir):
    out = str(fixture_dir / "window.avi")
    seen = []
    result = tvd.main(_args(fixture_dir, out, "--every-n", "2",
                            "--max-frames", "2", "--device", "cpu"),
                      on_depth=lambda i, depth: seen.append(i))
    fps, frames = _decoded(out)
    assert result["frames"] == 2 and frames.shape[0] == 2 and fps == 5.0
    assert seen == [0, 2]
    out = str(fixture_dir / "fps.avi")
    tvd.main(_args(fixture_dir, out, "--fps", "7.5", "--device", "cpu"))
    assert _decoded(out)[0] == 7.5


@pytest.mark.parametrize("flags", [["--int8"], ["--token-merge", "0.3"],
                                   ["--int8", "--int8-calib", "2"]])
def test_unported_flags_exit_with_an_error(fixture_dir, flags, tmp_path):
    """The speed dials, refused until the port had them, now run through
    the engine: every frame written, each depth map finite and in [0,
    max_depth], and moved away from the default run's."""
    runs = {}
    for name, extra in (("default", []), ("dial", flags)):
        out = str(tmp_path / f"{name}.avi")
        depths = {}
        result = tvd.main(_args(fixture_dir, out, *extra, "--device", "cpu"),
                          on_depth=depths.__setitem__)
        assert result["frames"] == 6 and _decoded(out)[1].shape[0] == 6
        runs[name] = depths
    for i, depth in runs["dial"].items():
        assert depth.shape == (64, 64) and np.isfinite(depth).all()
        assert depth.min() >= 0.0 and depth.max() <= 20.0
    assert sorted(runs["dial"]) == list(range(6))
    assert any(not np.array_equal(runs["dial"][i], runs["default"][i])
               for i in range(6))


def test_non_mjpeg_input_raises(fixture_dir, tmp_path):
    path = str(tmp_path / "x.mp4")
    with tnative.VideoWriter(path, 64, 48) as w:
        w.write_rgb(_smooth_rgb(48, 64, 0))
    with open(path, "rb") as f:
        data = bytearray(f.read())
    at = data.index(b"jpeg", data.index(b"stsd"))
    data[at:at + 4] = b"avc1"
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="'avc1' is not MJPEG"):
        tvd.main(["--encoder", "vitt", "-i", path, "-o",
                  str(tmp_path / "o.avi"), "--device", "cpu"])


def test_load_from_a_checkpoint_dir_takes_the_best(tmp_path):
    """A directory is the port's own training output: the save with the
    lowest val_loss, as the JAX package's best-checkpoint flow."""
    class State:
        def __init__(self, seed):
            self.model = build_depth_model("vitt", device="cpu", seed=seed)

        def state_dict(self):
            return {"model": self.model.state_dict(), "step": 0}

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    best = State(seed=5)
    mgr.save(1, best, {"val_loss": 1.0})
    mgr.save(2, State(seed=6), {"val_loss": 2.0})
    model = load_or_init_depth_model("vitt", 20.0, str(tmp_path / "ckpt"),
                                     device="cpu")
    for key, value in best.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    with pytest.raises(FileNotFoundError):
        load_or_init_depth_model("vitt", 20.0, str(tmp_path), device="cpu")


def test_convert_video_round_trip(fixture_dir, capsys):
    out = str(fixture_dir / "remux.mp4")
    tconvert_video.main([str(fixture_dir / "in.avi"), "-o", out])
    assert out in capsys.readouterr().out
    with tnative.VideoReader(str(fixture_dir / "in.avi")) as a, \
            tnative.VideoReader(out) as b:
        assert b.num_frames == a.num_frames == 6 and b.fps == a.fps
        assert all(a.frame_bytes(i) == b.frame_bytes(i) for i in range(6))
