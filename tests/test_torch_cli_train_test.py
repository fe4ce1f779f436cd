"""The port's ``train_depth`` and ``test_depth`` entry points and
``DepthTask.eval_step_per_sample`` against the JAX package's, on the CPU
(vitt, 56 px, f32).

Tolerances (f32 on both sides, JAX's matmuls at ``highest``): loss,
abs_rel, rmse and l1 within 1e-4 relative (f32 rounding through a
4-block encoder and the DPT head); d1, a share of pixels under a
threshold, within two pixels of a 56x56 map (a pixel whose ratio lies
within rounding of 1.1 may land on either side).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.cli import test_depth as jtest
from e3d_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.models.convert import convert_dav2, synthetic_dav2_state_dict
from e3d_tpu.train import DepthTask as JaxDepthTask
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import test_depth as ttest
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import train_depth as ttrain
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import config as cfglib
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import (
    make_c3vd_fixture, make_simcol_fixture)
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import load_dav2_state_dict
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
HW = 56
RTOL = 1e-4
D1_ATOL = 2.0 / (HW * HW)


def _close(got, want, key):
    if key == "d1":
        np.testing.assert_allclose(got, want, atol=D1_ATOL, rtol=0,
                                   err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7,
                                   err_msg=key)


def test_eval_step_per_sample_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.normal(0, 1, (3, HW, HW, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 18.0, (3, HW, HW, 1)).astype(np.float32)
    depth[0, :10] = 0.0     # below min_depth
    depth[1, :, :5] = 25.0  # above max_depth
    maxd = np.array([20.0, 10.0, 20.0], np.float32)
    args = dict(encoder="vitt", min_depth=1e-6, max_depth=20.0,
                grad_checkpoint=False)
    jtask = JaxDepthTask(policy=J_F32, **args)
    weights = synthetic_dav2_state_dict("vitt", 1)
    params = convert_dav2(weights, "vitt")
    with jax.default_matmul_precision("highest"):
        want = jtask.eval_step_per_sample(
            params, {"image": jnp.asarray(image), "depth": jnp.asarray(depth),
                     "max_depth": jnp.asarray(maxd)})
    ttask = DepthTask(policy=POLICY_F32, device="cpu", **args)
    model = build_depth_model("vitt", 20.0, torch.float32, device="cpu")
    load_dav2_state_dict(model, weights)
    got = ttask.eval_step_per_sample(model, {"image": image, "depth": depth,
                                             "max_depth": maxd})
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == (3,)
        _close(got[key].numpy(), np.asarray(want[key]), key)


@pytest.fixture(scope="module")
def simcol(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_test")
    make_simcol_fixture(str(root / "simcol"), n_procedures=3,
                        frames_per_proc=4, hw=64, seed=2)
    make_c3vd_fixture(str(root / "c3vd"), n_scenes=2, frames=2, hw=48,
                      seed=3)
    torch.save({f"model.{k}": torch.from_numpy(v)
                for k, v in synthetic_dav2_state_dict("vitt", 0).items()},
               root / "vitt.pth")
    return root


def _overrides(root, ds="simcol"):
    common = ["dataset.batch_size=2", "dataset.num_workers=2",
              f"dataset.size={HW}", "model.encoder=vitt",
              "trainer.precision=32-true"]
    if ds == "combined":
        s, c = root / "simcol", root / "c3vd"
        return ["dataset=combined", f"dataset.simcol_data_dir={s}",
                f"dataset.simcol_train_list={s}/train.txt",
                f"dataset.simcol_val_list={s}/val.txt",
                f"dataset.simcol_test_list={s}/test.txt",
                f"dataset.c3vd_data_dir={c}",
                f"dataset.c3vd_train_list={c}/train.txt",
                f"dataset.c3vd_val_list={c}/val.txt"] + common
    data = root / "simcol"
    return [f"dataset.data_dir={data}",
            f"dataset.train_list={data}/train.txt",
            f"dataset.val_list={data}/val.txt",
            f"dataset.test_list={data}/test.txt"] + common


def _test_cli(main, root, tmp_path, monkeypatch, ckpt, name, *extra,
              ds="simcol"):
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    monkeypatch.setenv("CHECKPOINT_PATH", str(ckpt))
    monkeypatch.setenv("E3D_RESULTS_DIR", str(tmp_path / name))
    main(_overrides(root, ds) + list(extra))
    with open(tmp_path / name / f"{ds}_results.json", encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("ds", ["simcol", "combined"])
def test_test_depth_matches_the_jax_cli(simcol, ds, tmp_path, monkeypatch):
    """Per-procedure, overall and (combined) per-source metrics, with
    C3VD's l1 and rmse back in mm."""
    monkeypatch.chdir(tmp_path)
    with jax.default_matmul_precision("highest"):
        want = _test_cli(jtest.main, simcol, tmp_path, monkeypatch,
                         simcol / "vitt.pth", "jax", ds=ds)
    got = _test_cli(ttest.main, simcol, tmp_path, monkeypatch,
                    simcol / "vitt.pth", "port", "--device", "cpu", ds=ds)
    assert sorted(got) == sorted(want)
    procs = ["SyntheticColon_I/S2", "SyntheticColon_I/S3"]
    if ds == "combined":  # C3VD samples carry their tree's name
        procs = procs + ["c3vd/c3vd"]
    assert sorted(got["procedure_metrics"]) == \
        sorted(want["procedure_metrics"]) == procs
    for proc, metrics in want["procedure_metrics"].items():
        for key, stats in metrics.items():
            _close(got["procedure_metrics"][proc][key]["mean"],
                   stats["mean"], key)
    for group in ("overall_metrics", "overall_metrics_per_sample"):
        for key, stats in want[group].items():
            _close(got[group][key]["mean"], stats["mean"], key)
            assert np.isfinite(got[group][key]["std"])
    for name, metrics in want.get("source_metrics", {}).items():
        assert got["source_metrics"][name]["count"] == metrics["count"] > 0
        for key in ("d1", "abs_rel", "rmse", "l1"):
            _close(got["source_metrics"][name][key]["mean"],
                   metrics[key]["mean"], key)
    assert (got["encoder"], got["ds_type"]) == ("vitt", ds)


@pytest.mark.parametrize("dial", ["++model.quant_int8=true",
                                  "++model.token_merge=0.3"])
def test_test_depth_runs_the_speed_dials(simcol, dial, tmp_path,
                                         monkeypatch):
    """The dials reach the evaluated model (finite metrics that move away
    from the default run's); train_depth refuses them, naming what they
    apply to."""
    monkeypatch.chdir(tmp_path)
    # The port's seeded init (LeCun-normal): the synthetic state dict's
    # N(0, 0.02) weights give near-constant maps that no dial moves.
    ckpt = tmp_path / "init.pth"
    torch.save(build_depth_model("vitt", device="cpu").state_dict(), ckpt)
    base = _test_cli(ttest.main, simcol, tmp_path, monkeypatch, ckpt,
                     "base", "--device", "cpu")
    got = _test_cli(ttest.main, simcol, tmp_path, monkeypatch, ckpt,
                    "dial", "--device", "cpu", dial)
    for key in ("d1", "abs_rel", "rmse", "l1"):
        assert np.isfinite(got["overall_metrics"][key]["mean"])
    assert got["overall_metrics"]["rmse"]["mean"] != \
        base["overall_metrics"]["rmse"]["mean"]
    with pytest.raises(SystemExit, match="apply to inference and "
                       "test_depth.*ROADMAP, \"Speed dials\""):
        ttrain.main(_overrides(simcol) + ["--device", "cpu", dial])


def test_train_then_test_on_its_checkpoint(simcol, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    out = ttrain.main(_overrides(simcol) + [
        "--device", "cpu", "model.use_checkpoint=true",
        "trainer.max_epochs=1", "trainer.accumulate_grad_batches=1",
        "++trainer.max_steps=2"])
    run_dir = tmp_path / out["run_dir"]
    assert run_dir.parent == tmp_path / "configs" / "experiments" / "simcol"
    with open(run_dir / "metrics.jsonl", encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    snap = run_dir / ".hydra" / "config.yaml"
    assert snap.exists() and (run_dir / ".hydra" / "overrides.yaml").exists()
    ckpt_dir = tmp_path / out["ckpt_dir"]
    assert list(ckpt_dir.glob("*/state.pt"))
    results = _test_cli(ttest.main, simcol, tmp_path, monkeypatch, ckpt_dir,
                        "after_train", "--device", "cpu")
    for key in ("d1", "abs_rel", "rmse", "l1"):
        assert np.isfinite(results["overall_metrics"][key]["mean"])


@pytest.mark.parametrize("override,item", [
    ("trainer.mesh_model=2", "Parallel modes"),
    ("trainer.mesh_data=4", "Parallel modes"),
    ("trainer.tensor_parallel=true", "Parallel modes"),
    ("trainer.seq_parallel=true", "Parallel modes"),
    ("trainer.fsdp=true", "Parallel modes"),
    ("trainer.pipeline_parallel=2", "Parallel modes"),
    ("++trainer.distributed=true", "Parallel modes"),
    ("trainer.distill_from=teacher.pth", "Distillation and NaN checks"),
    ("++trainer.debug_nans=true", "Distillation and NaN checks"),
])
def test_unported_knobs_exit_naming_their_item(simcol, override, item,
                                               tmp_path, monkeypatch):
    """Every knob that was refused until the port had it now does in one
    process what it does in the JAX package (the item names what was
    ported): a mesh larger than the world raises the JAX package's message
    for one device; ``pipeline_parallel=2`` its guard at ``mesh_model=1``;
    ``distributed=true`` without torchrun's environment names the missing
    variables; TP, SP and FSDP on one rank are the plain path, which
    trains. Distillation and the NaN checks are no longer listed (their
    runs: ``tests/test_torch_distill.py``, ``tests/test_torch_debug.py``);
    none of the knobs is refused."""
    from e3d_tpu.parallel import mesh as jmesh

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "E3D_DIST_INIT"):
        monkeypatch.delenv(var, raising=False)
    cfg = cfglib.compose(CONFIG_ROOT, "default",
                         _overrides(simcol) + [override])
    assert ttrain.unported_knobs(cfg) == []
    if item == "Distillation and NaN checks":
        assert cfg.trainer.get(override.split("=")[0].split(".")[-1])
        return
    argv = _overrides(simcol) + ["--device", "cpu", override,
                                 "++trainer.max_steps=1",
                                 "trainer.max_epochs=1"]
    name = override.split("=")[0].split(".")[-1]
    if name in ("mesh_model", "mesh_data"):
        spec = dict(mesh_model=(-1, 2), mesh_data=(4, 1))[name]
        with pytest.raises(ValueError) as want:
            jmesh.build_mesh(jmesh.MeshSpec(*spec), devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            ttrain.main(argv)
        assert str(got.value) == str(want.value) == (
            f"mesh {max(spec[0], 0)}x{spec[1]} != 1 devices")
    elif name == "pipeline_parallel":
        with pytest.raises(ValueError, match=r"pipeline_parallel=2 needs "
                           r"mesh_model=2 \(got 1\)"):
            ttrain.main(argv)
    elif name == "distributed":
        with pytest.raises(RuntimeError, match="missing RANK, WORLD_SIZE, "
                           "LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
            ttrain.main(argv)
    else:
        out = ttrain.main(argv)
        assert list((tmp_path / out["ckpt_dir"]).glob("*/state.pt"))
    # The mesh and the process group come before the run directory is
    # written, the task's guards after it (as in the JAX package).
    assert (tmp_path / "configs").exists() == (
        name not in ("mesh_model", "mesh_data", "distributed"))


def test_pose_and_orbax_raise_naming_their_item(simcol, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    # ds_type pose now builds the port's pose-pair datamodule, as the JAX
    # package's build_datamodule does.
    s = simcol / "simcol"
    pose = ttrain.build_datamodule({
        "ds_type": "pose", "data_dir": str(s),
        "train_list": f"{s}/train.txt", "val_list": f"{s}/val.txt",
        "test_list": f"{s}/test.txt", "batch_size": 2, "size": HW})
    pose.setup("fit")
    assert pose.train_dataset[0]["input"].shape == (8, HW, HW)
    orbax = tmp_path / "orbax"
    JaxCheckpointManager(str(orbax)).save(
        1, {"w": np.zeros(2, np.float32)}, {"val_loss": 1.0})
    monkeypatch.setenv("CHECKPOINT_PATH", str(orbax))
    with pytest.raises(ValueError, match="orbax_to_torch.py"):
        ttest.main(_overrides(simcol) + ["--device", "cpu"])
