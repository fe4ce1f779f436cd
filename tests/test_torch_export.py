"""The port's export of the serving program (``serving/export.py``,
``cli/export_model.py``) on the CPU, against the JAX package's.

One vitt export at (60, 60) frames, batch 2, 56 px, in f32, is shared by
the file: the port's seeded weights, taken into the JAX package's layout
by its ``convert_dav2`` and back by ``from_jax_params``, so that both
packages hold the same weights.
On the CPU every kernel op is its plain version, so the replay equals the
live program bit for bit; against the JAX package's own export of the
same weights the replay is held to 5e-4 m, the f32 bound of
``tests/test_torch_depth_anything.py``.

Fault 3.1 (ROADMAP): tracing filled the port's device caches with fake
tensors, so a live forward after an export returned FakeTensors. Each
export here runs with the caches emptied first, as in a fresh process,
and the live program runs after it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

import e3d_tpu  # noqa: F401
from e3d_tpu.models import build_depth_model as jax_build
from e3d_tpu.models.convert import convert_dav2
from e3d_tpu.serving import export as jexport
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import export_model as texport_cli
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import dinov2 as tdino
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_params, load_dav2_state_dict
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant as tquant
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving import export as texport
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

FRAME_HW = (60, 60)
BATCH = 2
INPUT_SIZE = 56
F32_ATOL = 5e-4  # m, as tests/test_torch_depth_anything.py
CACHES = (tres._device_matrix, tres._device_taps, tdino._bicubic_tensor)


def _clear_caches():
    for cache in CACHES:
        cache.cache_clear()


def _rgb01(seed: int, hw=FRAME_HW) -> np.ndarray:
    return np.random.default_rng(seed).random((BATCH, *hw, 3), np.float32)


def _live(model, rgb01: np.ndarray) -> torch.Tensor:
    h, w = rgb01.shape[1:3]
    return tda._run_batched(model, torch.from_numpy(rgb01),
                            tda._lower_bound_hw(h, w, INPUT_SIZE), (h, w))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jmodel = jax_build("vitt", max_depth=20.0, dtype=jnp.float32)
    model = tda.build_depth_model("vitt", 20.0, torch.float32, device="cpu")
    jparams = convert_dav2({k: v.numpy() for k, v in
                            model.state_dict().items()}, "vitt")
    load_dav2_state_dict(model, from_jax_params(jparams))
    params = model.state_dict()
    path = str(tmp_path_factory.mktemp("export") / "vitt.pt2")
    _clear_caches()
    meta = texport.export_depth_program(model, params, path, FRAME_HW,
                                        batch_size=BATCH,
                                        input_size=INPUT_SIZE)
    # The live program right after the export, with the caches the
    # export left (fault 3.1's order).
    after = _live(model, _rgb01(0))
    return {"jmodel": jmodel, "jparams": jparams, "model": model,
            "params": params, "path": path, "meta": meta, "after": after,
            "prog": texport.load_exported(path)}


def _cached_tensors():
    """Tensors the device caches hand out for the shapes of this file's
    programs: the (60, 60) <-> 56 px resizes and the (3, 5) grid's
    pos-embed matrices."""
    return [tres._device_matrix(tres._antialias_matrix, 60, 56, "bicubic",
                                torch.float32, torch.device("cpu")),
            tres._device_matrix(tres._align_corners_matrix, 56, 60,
                                "bilinear", torch.float32,
                                torch.device("cpu")),
            tdino._bicubic_tensor(3, 4, torch.device("cpu")),
            tdino._bicubic_tensor(5, 4, torch.device("cpu"))]


def test_live_program_after_an_export_is_real(exported):
    """Fault 3.1 at the square grid: the live program after the export
    gives real tensors, equal to a run with emptied caches."""
    after = exported["after"]
    assert type(after) is torch.Tensor and not is_fake(after)
    _clear_caches()
    fresh = _live(exported["model"], _rgb01(0))
    assert torch.equal(after, fresh)


def test_replay_equals_live_bit_for_bit(exported):
    prog = exported["prog"]
    assert prog.meta == exported["meta"]
    x = _rgb01(1)
    got = prog(exported["params"], x)
    assert got.shape == (BATCH, *FRAME_HW) and got.dtype == torch.float32
    assert torch.equal(got, _live(exported["model"], x))
    # A live program of the module and the replay agree as well.
    live = texport._program(exported["model"], (56, 56), FRAME_HW)(
        exported["params"], torch.from_numpy(x))
    assert torch.equal(got, live)


def test_artifact_holds_no_weights(exported):
    """The params stay call-time inputs: the artifact is smaller than
    their bytes and holds no state, no example inputs and no constant
    equal to a parameter."""
    params, meta = exported["params"], exported["meta"]
    param_bytes = sum(v.numel() * v.element_size() for v in params.values())
    assert 0 < meta["artifact_bytes"] == os.path.getsize(exported["path"])
    assert meta["artifact_bytes"] < param_bytes
    ep = exported["prog"].program
    assert not ep.state_dict and ep.example_inputs is None
    for const in ep.constants.values():
        for p in params.values():
            assert not (const.shape == p.shape and torch.equal(const, p))


def test_shape_device_and_manifest_guards(exported, monkeypatch):
    prog = exported["prog"]
    params = exported["params"]
    with pytest.raises(ValueError, match="fixed-shape"):
        prog(params, np.zeros((BATCH, 60, 48, 3), np.float32))
    missing = dict(params)
    missing.pop("pretrained.cls_token")
    with pytest.raises(ValueError, match="manifest"):
        prog(missing, _rgb01(2))
    run = texport.exported_runner(prog, params)
    monkeypatch.setitem(prog.meta, "platforms", ["cuda"])
    with pytest.raises(ValueError, match=r"traced on \['cuda'\].*cpu"):
        prog(params, _rgb01(2))
    with pytest.raises(ValueError, match=r"serves \(60, 60, 3\) frames"):
        run([np.zeros((48, 60, 3), np.uint8)])


def test_metadata_sidecar(exported):
    """The keys of the JAX package's sidecar, and the port's own."""
    with open(exported["path"] + ".json", encoding="utf-8") as f:
        on_disk = json.load(f)
    assert on_disk == exported["meta"]
    assert on_disk["format"] == "torch.export"
    assert on_disk["encoder"] == "vitt" and on_disk["platforms"] == ["cpu"]
    assert on_disk["net_hw"] == [56, 56] and on_disk["frame_hw"] == [60, 60]
    assert (on_disk["batch_size"], on_disk["input_size"]) == (BATCH, 56)
    assert on_disk["dtype"] == "float32" and not on_disk["quant_int8"]
    assert on_disk["int8_calib_amax"] is None
    assert on_disk["forward_schedule"] == "plain"
    assert on_disk["pallas_resize"] is False
    assert on_disk["lerp_resize_nodes"] == 0  # vitt: 32-channel resizes
    jax_keys = {"format", "encoder", "max_depth", "frame_hw", "net_hw",
                "batch_size", "input_size", "platforms", "dtype",
                "quant_int8", "quant_scope", "quant_dpt", "token_merge",
                "int8_calib_batches", "int8_calib_amax", "artifact_bytes",
                "param_manifest"}
    assert jax_keys <= set(on_disk)
    manifest = on_disk["param_manifest"]
    assert list(manifest) == list(exported["params"])
    assert manifest["pretrained.pos_embed"] == [[1, 17, 64], "float32"]


@pytest.mark.parametrize("knob", [True, False])
def test_sidecar_counts_the_k6_the_program_holds(knob, monkeypatch):
    """``lerp_resize_nodes`` counts the K6 calls a traced program holds:
    two 128-channel resizes under ``E3D_PALLAS_RESIZE=1`` (on the CPU
    through the plain version), none with the knob unset (the CPU's
    matmul resize)."""
    monkeypatch.setattr(tres, "_PALLAS_RESIZE", knob)

    class Up(torch.nn.Module):
        def forward(self, x):
            y = tres.resize_align_corners(x, (7, 9), channels_last=False)
            return tres.resize_align_corners(y, (11, 13), channels_last=False)

    x = torch.zeros((1, 128, 4, 5)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        ep = torch.export.export(Up(), (x,), strict=False)
    assert texport.lerp_resize_nodes(ep) == (2 if knob else 0)


def test_replay_matches_the_jax_export(exported, tmp_path):
    """The JAX package's export of the same weights, replayed, against the
    port's replay on the same seeded frames: f32 within 5e-4 m."""
    path = str(tmp_path / "vitt.stablehlo")
    jexport.export_depth_program(exported["jmodel"], exported["jparams"],
                                 path, frame_hw=FRAME_HW, batch_size=BATCH,
                                 input_size=INPUT_SIZE)
    x = _rgb01(3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jexport.load_exported(path)(exported["jparams"],
                                                      x))
    got = exported["prog"](exported["params"], x)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def test_runner_pads_ragged_tails(exported):
    prog = exported["prog"]
    run = texport.exported_runner(prog, exported["params"])
    frames = list(np.random.default_rng(4).integers(
        0, 256, (3, *FRAME_HW, 3), dtype=np.uint8))
    maps = run(frames)
    assert len(maps) == 3 and all(m.shape == FRAME_HW for m in maps)
    tail = np.stack(frames[2:] * 2)
    tail[1:] = 0
    rgb01 = tda.rgb01_of_bgr_u8(torch.from_numpy(tail))
    np.testing.assert_array_equal(maps[2], prog(exported["params"],
                                                rgb01)[0].numpy())
    # The live runner on the same frames: the same maps.
    live = tda.BatchedRunner(exported["model"], FRAME_HW, INPUT_SIZE,
                             BATCH)(frames)
    for got, want in zip(maps, live):
        np.testing.assert_array_equal(got, want)


def test_int8_calibrated_artifact(tmp_path):
    """--int8-calib at export: the sidecar's amax equals a live
    ``calibrate_scales`` over the same batches, and the replay equals the
    frozen-scale live program."""
    model = tda.build_depth_model("vitt", 20.0, torch.float32, device="cpu",
                                  quant_int8=True)
    params = model.state_dict()
    frames = list(np.random.default_rng(5).integers(
        0, 256, (2 * BATCH, *FRAME_HW, 3), dtype=np.uint8))
    path = str(tmp_path / "int8.pt2")
    meta = texport.export_depth_program(model, params, path, FRAME_HW,
                                        batch_size=BATCH,
                                        input_size=INPUT_SIZE,
                                        calib_frames=frames,
                                        calib_batches=2)
    live = texport._program(model, (56, 56), FRAME_HW)
    batches = [torch.from_numpy(a)
               for a, _ in tda.chunk_rgb01(frames, BATCH)]
    amax = tquant.calibrate_scales(lambda x: live(params, x), batches)
    assert meta["quant_int8"] and meta["int8_calib_batches"] == 2
    assert meta["int8_calib_amax"] == [float(v) for v in amax.numpy()]
    x = _rgb01(6)
    got = texport.load_exported(path)(params, x)
    frozen = texport._Program(model, (56, 56), FRAME_HW, amax)
    assert torch.equal(got, frozen(params, torch.from_numpy(x)))


def test_export_model_check_at_a_non_square_grid(tmp_path, capsys):
    """``export_model --check`` exports first and runs the live program
    afterwards (fault 3.1's order) at a (3, 5) patch grid, which also
    resizes the pos-embed: the check passes, and the caches hold real
    tensors equal to fresh ones."""
    _clear_caches()
    out = str(tmp_path / "grid.pt2")
    meta = texport_cli.main(["--device", "cpu", "--encoder", "vitt",
                             "--frame-hw", "48", "80", "--batch-size", "2",
                             "--input-size", "42", "-o", out, "--check"])
    assert meta["net_hw"] == [42, 70] and meta["check_max_abs"] == 0.0
    assert "replay check: max |exported - live| = 0.000e+00" in \
        capsys.readouterr().out
    cached = tdino._bicubic_tensor(3, 4, torch.device("cpu"))
    assert not is_fake(cached)
    assert torch.equal(cached, torch.from_numpy(
        tdino._torch_bicubic_matrix(3, 4)))
    for t in _cached_tensors():
        assert type(t) is torch.Tensor and not is_fake(t)


def test_export_model_train_end_to_end(tmp_path, capsys):
    """``export_model --train --device cpu`` end to end: the training
    step of the CLI's own task (bf16, its default policy; seeded weights)
    and its sidecar are written, the JAX CLI's line printed, and the
    replay on a state of that task takes the live step, bit for bit on
    the CPU."""
    out = str(tmp_path / "train.pt2")
    meta = texport_cli.main(["--train", "--device", "cpu", "--encoder",
                             "vitt", "--input-size", "28", "--microbatch",
                             "2", "--grad-accum", "2", "--total-steps", "8",
                             "-o", out])
    assert (f"[export] {out}: {meta['artifact_bytes']} bytes, "
            "platforms=['cpu'], train step accum2 x bs2 @ [28, 28]"
            in capsys.readouterr().out)
    with open(out + ".json", encoding="utf-8") as f:
        assert json.load(f) == meta
    assert (meta["kind"], meta["dtype"], meta["total_steps"]) == (
        "depth_train_step", "bfloat16", 8)
    prog = texport.load_exported_train_step(out)
    task = DepthTask(encoder="vitt", total_steps=8, grad_accum=2,
                     device="cpu")
    replayed, live = task.init_state(0), task.init_state(0)
    rng = np.random.default_rng(8)
    batch = {"image": rng.normal(size=(2, 2, 28, 28, 3)).astype(np.float32),
             "depth": rng.uniform(0.5, 19.0, (2, 2, 28, 28, 1)).astype(
                 np.float32)}
    # Exported without them, the step takes no max_depth or weight.
    with pytest.raises(ValueError, match="fixed-shape.*got max_depth"):
        prog(replayed, {**batch, "max_depth": np.ones((2, 2), np.float32)})
    replayed, got = prog(replayed, batch)
    live, want = task.train_step(live, batch)
    assert {k: v.item() for k, v in got.items()} == {
        k: v.item() for k, v in want.items()}
    got_sd, want_sd = replayed.state_dict(), live.state_dict()
    for k, v in want_sd["model"].items():
        assert torch.equal(got_sd["model"][k], v), k
    for i, s in want_sd["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got_sd["optimizer"]["state"][i][k], v), (i, k)
    assert replayed.step == live.step == 1


def test_a_fresh_process_replays_the_artifact(exported, tmp_path):
    """``load_exported`` registers the kernel ops before the program loads:
    a process that imported nothing of the port's ops replays it."""
    x = _rgb01(7)
    np.save(tmp_path / "x.npy", x)
    torch.save(exported["params"], tmp_path / "params.pt")
    code = (
        "import sys, numpy as np, torch\n"
        "from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
        "depth_and_pose_estimation_tpu_torch.serving import export\n"
        "assert not any(m.endswith('.ops.flash_attention') "
        "for m in sys.modules)\n"
        f"prog = export.load_exported({exported['path']!r})\n"
        f"params = torch.load({str(tmp_path / 'params.pt')!r})\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, prog(params, x).numpy())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  _live(exported["model"], x).numpy())
