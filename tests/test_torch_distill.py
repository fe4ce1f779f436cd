"""Distillation in the port's ``DepthTask`` and ``train_depth`` against the
JAX package's, on the CPU (vitt, 56 px, f32).

The student and the teacher are two seeded vitt models of the port,
carried into the JAX package's layout by its ``convert_dav2``. The loss
with the distillation term and the term itself agree within 1e-4
relative, the f32 bound of ``tests/test_torch_cli_train_test.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.models.convert import convert_dav2
from e3d_tpu.train import DepthTask as JaxDepthTask
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import train_depth as ttrain
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
HW = 56
RTOL = 1e-4
ARGS = dict(encoder="vitt", min_depth=1e-6, max_depth=20.0,
            grad_checkpoint=False, total_steps=4, grad_accum=2)


def _batch(seed=0, accum=2, mb=2):
    rng = np.random.default_rng(seed)
    image = rng.normal(0, 1, (accum, mb, HW, HW, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 18.0, (accum, mb, HW, HW, 1)).astype(
        np.float32)
    depth[:, :, :6] = 0.0  # below min_depth
    return {"image": image, "depth": depth}


def _weights(seed):
    return build_depth_model("vitt", 20.0, torch.float32, device="cpu",
                             seed=seed).state_dict()


def _task(**kw):
    return DepthTask(policy=POLICY_F32, device="cpu", **{**ARGS, **kw})


def test_distill_term_matches_jax():
    student, teacher = _weights(0), _weights(1)
    batch = _batch()
    image, depth = batch["image"][0], batch["depth"][0]
    maxd = np.full((2,), 20.0, np.float32)
    jtask = JaxDepthTask(policy=J_F32, distill_encoder="vitt",
                         distill_weight=0.7, **ARGS)
    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    with jax.default_matmul_precision("highest"):
        jloss, jmet = jtask._loss_and_metrics(
            convert_dav2(as_np(student), "vitt"), jnp.asarray(image),
            jnp.asarray(depth), jnp.asarray(maxd),
            teacher_params=convert_dav2(as_np(teacher), "vitt"))
    ttask = _task(distill_encoder="vitt", distill_weight=0.7)
    ttask.set_teacher(teacher)
    state = ttask.init_state(pretrained_params=student)
    with torch.no_grad():
        loss, met = ttask._loss_and_metrics(
            state.model.eval(), torch.from_numpy(image),
            torch.from_numpy(depth), torch.from_numpy(maxd), distill=True)
    assert float(met["distill"]) > 0.01  # two models, two maps
    np.testing.assert_allclose(float(met["distill"]), float(jmet["distill"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for key in ("abs_rel", "rmse", "l1"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=RTOL)


def test_zero_weight_is_the_plain_step():
    """distill_weight=0: the same loss and the same parameters after the
    step as a task without a teacher, bit for bit."""
    student = _weights(0)
    batch = _batch(1)
    plain = _task()
    pstate = plain.init_state(pretrained_params=student)
    zero = _task(distill_encoder="vitt", distill_weight=0.0)
    zero.set_teacher(_weights(1))
    zstate = zero.init_state(pretrained_params=student)
    pstate, pmet = plain.train_step(pstate, batch)
    zstate, zmet = zero.train_step(zstate, batch)
    assert "distill" not in pmet and float(zmet["distill"]) > 0.01
    assert torch.equal(pmet["loss"], zmet["loss"])
    for (name, a), b in zip(pstate.model.state_dict().items(),
                            zstate.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_self_distillation_is_near_zero():
    """A teacher with the student's own weights: the term is SiLog's floor
    (sqrt of its 1e-12 guard), and the teacher holds copies."""
    student = _weights(0)
    task = _task(distill_encoder="vitt")
    task.set_teacher(student)
    state = task.init_state(pretrained_params=student)
    _, met = task.train_step(state, _batch(2))
    assert 0.0 <= float(met["distill"]) <= 1e-5
    ids = {p.data_ptr() for p in state.model.parameters()}
    assert not ids & {p.data_ptr() for p in task.teacher.parameters()}
    assert not any(p.requires_grad for p in task.teacher.parameters())


def test_set_teacher_after_a_first_step():
    """The step keeps nothing built before ``set_teacher``: the term
    appears at the next step (the JAX step's cache key leaves the teacher
    out)."""
    task = _task(distill_encoder="vitt")
    state = task.init_state(pretrained_params=_weights(0))
    state, met = task.train_step(state, _batch(3))
    assert "distill" not in met
    task.set_teacher(_weights(1))
    state, met = task.train_step(state, _batch(4))
    assert np.isfinite(float(met["distill"])) and float(met["distill"]) > 0
    with pytest.raises(ValueError, match="without distill_encoder"):
        _task().set_teacher(_weights(1))


def test_train_depth_with_distill_from(tmp_path, monkeypatch):
    """``trainer.distill_from``: the teacher from its checkpoint, the term
    logged as ``Train/train_distill`` at every step."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    make_simcol_fixture(str(tmp_path / "simcol"), n_procedures=3,
                        frames_per_proc=4, hw=64, seed=2)
    torch.save(_weights(1), tmp_path / "teacher.pth")
    s = tmp_path / "simcol"
    out = ttrain.main([
        "--device", "cpu", f"dataset.data_dir={s}",
        f"dataset.train_list={s}/train.txt", f"dataset.val_list={s}/val.txt",
        f"dataset.test_list={s}/test.txt", "dataset.batch_size=2",
        "dataset.num_workers=2", f"dataset.size={HW}", "model.encoder=vitt",
        "trainer.precision=32-true", "model.use_checkpoint=false",
        "trainer.max_epochs=1", "trainer.accumulate_grad_batches=1",
        "++trainer.max_steps=2", "++trainer.log_every_n_steps=1",
        f"trainer.distill_from={tmp_path / 'teacher.pth'}",
        "++trainer.distill_encoder=vitt", "++trainer.distill_weight=0.5"])
    with open(tmp_path / out["run_dir"] / "metrics.jsonl",
              encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    distill = [r["Train/train_distill"] for r in records
               if "Train/train_distill" in r]
    assert len(distill) == 2 and all(np.isfinite(distill))
    assert all(d > 0 for d in distill)
