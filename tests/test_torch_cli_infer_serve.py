"""The port's ``infer`` and ``serve`` entry points against the JAX
package's, on the CPU: the same vitt ``.pth`` (``synthetic_dav2_state_dict``),
the same 64x64 frames, ``--input-size 56``.

Both sides run in f32 here (the model built in f32, JAX's matmuls at
``highest``), so their ``.npy`` maps agree within 5e-4 m, the f32 bound
of ``tests/test_torch_depth_anything.py``; the CLIs' own default, bf16,
differs between the frameworks by rounding alone (that file bounds it).
The file layouts must be equal, name for name.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import e3d_tpu  # noqa: F401
from e3d_tpu.cli import infer as jinfer
from e3d_tpu.cli import serve as jserve
from e3d_tpu.models import depth_anything as jda
from e3d_tpu.models.convert import synthetic_dav2_state_dict
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import export_model as texport_cli
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import infer as tinfer
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import serve as tserve
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.io import decode_rgb
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import colormap
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.media import native as tnative
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import convert as tconvert

F32_ATOL = 5e-4  # m, as tests/test_torch_depth_anything.py
N_FLAT = 5


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_infer")
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_dav2_state_dict("vitt", 0).items()},
               root / "vitt.pth")
    make_simcol_fixture(str(root / "simcol"), n_procedures=2,
                        frames_per_proc=3, hw=64, seed=0)
    flat = root / "flat"
    flat.mkdir()
    rng = np.random.default_rng(1)
    for i in range(N_FLAT):
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        (flat / f"frame_{i:04d}.jpg").write_bytes(
            tnative.encode_jpeg(img, 95))
    return root


@pytest.fixture
def f32(monkeypatch):
    """Both CLIs' models in f32, JAX's matmuls at full precision."""
    monkeypatch.setattr(jda, "build_depth_model", functools.partial(
        jda.build_depth_model, dtype=jnp.float32))
    monkeypatch.setattr(tconvert, "load_or_init_depth_model",
                        functools.partial(tconvert.load_or_init_depth_model,
                                          dtype=torch.float32))
    with jax.default_matmul_precision("highest"):
        yield


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_outputs(jroot, troot):
    names = _files(jroot)
    assert names == _files(troot)
    npys = [n for n in names if n.endswith(".npy")]
    assert npys
    for name in npys:
        want = np.load(os.path.join(jroot, name))
        got = np.load(os.path.join(troot, name))
        assert got.shape == want.shape == (64, 64) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0,
                                   err_msg=name)


def _infer_args(env, root, kind, batch):
    args = ["--encoder", "vitt", "--load-from", str(env / "vitt.pth"),
            "-i", str(root), "--input-size", "56", "--save-numpy",
            "--batch-size", str(batch)]
    return args + (["-d", "simcol"] if kind == "simcol"
                   else ["-o", str(root / "out")])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["simcol", "flat"])
def test_infer_matches_the_jax_cli(env, f32, kind, batch, tmp_path):
    jroot = shutil.copytree(env / kind, tmp_path / "jax")
    troot = shutil.copytree(env / kind, tmp_path / "port")
    jinfer.main(_infer_args(env, jroot, kind, batch))
    args = _infer_args(env, troot, kind, batch) + ["--device", "cpu"]
    result = tinfer.main(args)
    n = 6 if kind == "simcol" else N_FLAT
    assert (result["total"], result["skipped"], result["processed"]) == \
        (n, 0, n)
    _assert_same_outputs(jroot, troot)
    if kind == "simcol":
        assert f"SyntheticColon_I{os.sep}Frames_S1_OP" in {
            os.path.dirname(f) for f in _files(troot)}
    # Skip-existing: every frame of the first run is skipped. (A SimCol
    # tree's glob, Frames_*, also takes the first run's Frames_*_OP
    # renderings as new frames, as the reference's run.py does.)
    again = tinfer.main(args)
    assert again["skipped"] == n
    assert again["processed"] == (n if kind == "simcol" else 0)


@pytest.mark.parametrize("flags", [["--pred-only", "--grayscale"],
                                   ["--pred-only"], []],
                         ids=["pred_only_gray", "pred_only", "side_by_side"])
def test_infer_pngs_are_the_renderings_of_the_maps(env, flags, tmp_path):
    root = shutil.copytree(env / "flat", tmp_path / "in")
    tinfer.main(_infer_args(env, root, "flat", 4) + flags
                + ["--device", "cpu"])
    for i in range(N_FLAT):
        stem = root / "out" / f"frame_{i:04d}"
        depth = np.load(f"{stem}.npy")
        rendered = colormap.colorize_depth(depth,
                                           grayscale="--grayscale" in flags)
        if "--pred-only" not in flags:
            raw = decode_rgb(str(root / f"frame_{i:04d}.jpg"))[..., ::-1]
            rendered = colormap.side_by_side(raw, rendered)
        np.testing.assert_array_equal(np.asarray(Image.open(f"{stem}.png")),
                                      rendered[..., ::-1])  # BGR -> RGB


def _serve_args(env, indir, outdir):
    return ["--encoder", "vitt", "--load-from", str(env / "vitt.pth"),
            "-i", str(indir), "-o", str(outdir), "--input-size", "56",
            "--batch-size", "4", "--once", "--save-numpy"]


def test_serve_once_matches_the_jax_cli(env, f32, tmp_path, capsys):
    indir = tmp_path / "incoming"
    indir.mkdir()
    frames = sorted((env / "simcol" / "SyntheticColon_I" / "Frames_S1")
                    .glob("FrameBuffer_*.png"))
    for f in frames:
        shutil.copy(f, indir / f.name)
    # A stem collision (the .jpg sorts first and wins on both sides) and
    # a truncated upload, which neither side can read.
    shutil.copy(env / "flat" / "frame_0000.jpg", indir / "FrameBuffer_0000.jpg")
    (indir / "cut.png").write_bytes(frames[1].read_bytes()[:300])
    jserve.main(_serve_args(env, indir, tmp_path / "jax"))
    result = tserve.main(_serve_args(env, indir, tmp_path / "port")
                         + ["--device", "cpu"])
    out = capsys.readouterr().out
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port")
    assert _files(tmp_path / "port") == sorted(
        f"{s}.{e}" for s in ("FrameBuffer_0000", "FrameBuffer_0001",
                             "FrameBuffer_0002") for e in ("npy", "png"))
    assert result["served"] == 3 and result["stats"]["completed"] == 3
    assert list(result["unread"]) == [str(indir / "cut.png")]
    assert "truncated 8-bit RGB PNG" in result["unread"][str(indir /
                                                             "cut.png")]
    assert "latency p50/p95/p99 = " in out
    assert "output stem collides" in out


def test_retry_tracker_parks_and_unparks(tmp_path):
    """``tests/test_serve_cli.py``'s scenario on the port's tracker."""
    path = tmp_path / "partial.png"
    t = tserve._ReadRetryTracker(patience=3)
    for _ in range(10):  # upload in progress: size grows, never parks
        with open(path, "ab") as f:
            f.write(b"x" * 100)
        assert t.note_failure(str(path)) is False
        assert t.parked(str(path)) is False
    os.utime(path, ns=(0, 0))  # stalled: the signature repeats
    assert t.note_failure(str(path)) is False
    assert t.note_failure(str(path)) is False
    assert t.note_failure(str(path)) is True
    assert t.parked(str(path)) is True
    assert t.note_failure(str(path)) is False  # logged once
    with open(path, "ab") as f:  # resumed: un-parked
        f.write(b"y" * 100)
    assert t.parked(str(path)) is False
    t.clear(str(path))
    assert not t._fails
    os.remove(path)  # deleted mid-poll: transient, not a park
    assert t.note_failure(str(path)) is False
    t.prune(set())
    assert not t._fails


@pytest.mark.parametrize("cli,flags,item", [
    ("infer", ["--int8"], "Speed dials"),
    ("infer", ["--token-merge", "0.3"], "Speed dials"),
    ("infer", ["--int8", "--int8-calib", "2"], "Speed dials"),
    ("serve", ["--int8"], "Speed dials"),
    ("serve", ["--token-merge", "0.3"], "Speed dials"),
    ("serve", ["--from-export", "prog.bin"], "Export"),
])
def test_unported_flags_exit_with_code_2(env, cli, flags, item, tmp_path,
                                         capsys):
    """Flags the port once refused now run. The speed dials each write
    every map, finite and in [0, max_depth], and move the maps away from
    the default run's. ``serve --from-export`` replays an artifact that
    ``export_model`` made of the same weights and writes the live serve's
    maps; a flag that contradicts the artifact's dials, and
    ``--int8-calib`` with it, still exit with code 2."""
    def run(extra, out):
        if cli == "infer":
            args = _infer_args(env, env / "flat", "flat", 4)[:-2]
            return tinfer.main(args + ["-o", str(out), "--device", "cpu"]
                               + extra)
        return tserve.main(_serve_args(env, env / "flat", out)
                           + ["--device", "cpu"] + extra)

    if item == "Export":
        artifact = str(tmp_path / flags[1])
        texport_cli.main(["--device", "cpu", "--encoder", "vitt",
                          "--load-from", str(env / "vitt.pth"),
                          "--frame-hw", "64", "64", "--batch-size", "4",
                          "--input-size", "56", "-o", artifact])
        run([], tmp_path / "live")
        out = run([flags[0], artifact], tmp_path / "replay")
        assert out["served"] == N_FLAT and not out["unread"]
        live = {p.name: np.load(p)
                for p in sorted((tmp_path / "live").rglob("*.npy"))}
        replay = {p.name: np.load(p)
                  for p in sorted((tmp_path / "replay").rglob("*.npy"))}
        assert len(live) == N_FLAT and sorted(replay) == sorted(live)
        for name, depth in replay.items():
            np.testing.assert_array_equal(depth, live[name])
        capsys.readouterr()
        for extra, what in ((["--int8"], "--int8 contradicts"),
                            (["--token-merge", "0.3"], "--token-merge 0.3"),
                            (["--input-size", "70"], "--input-size 70"),
                            (["--int8", "--int8-calib", "1"],
                             "--int8-calib does not apply")):
            with pytest.raises(SystemExit) as exc:
                tserve.main(_serve_args(env, env / "flat", tmp_path / "x")
                            + ["--device", "cpu", flags[0], artifact]
                            + extra)
            assert exc.value.code == 2
            assert what in capsys.readouterr().err
        assert not (tmp_path / "x").exists()
        return
    run([], tmp_path / "default")
    run(flags, tmp_path / "dial")
    default = {p.name: np.load(p)
               for p in sorted((tmp_path / "default").rglob("*.npy"))}
    dial = {p.name: np.load(p)
            for p in sorted((tmp_path / "dial").rglob("*.npy"))}
    assert len(default) == N_FLAT and sorted(dial) == sorted(default)
    for name, depth in dial.items():
        assert depth.shape == (64, 64) and np.isfinite(depth).all()
        assert depth.min() >= 0.0 and depth.max() <= 20.0
    assert any(not np.array_equal(dial[k], default[k]) for k in dial)


def test_infer_int8_calib_needs_int8_and_batching(env, tmp_path, capsys):
    args = _infer_args(env, env / "flat", "flat", 1)[:-2] + [
        "-o", str(tmp_path / "o"), "--device", "cpu"]
    for extra in (["--int8", "--int8-calib", "2"], ["--int8-calib", "2"]):
        with pytest.raises(SystemExit) as exc:
            tinfer.main(args + extra)
        assert exc.value.code == 2
    assert "--int8-calib requires --int8" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
