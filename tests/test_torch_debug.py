"""``core.debug.nan_checks``, the port's ``jax_debug_nans``, on the CPU:
it raises ``FloatingPointError`` at the first op that makes a NaN, in the
forward (naming the op and the module) and in the backward, lets
everything through when it is off, nests, restores the previous state on
exit, and runs behind ``train_depth``'s ``trainer.debug_nans``."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import train_depth as ttrain
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import debug as tdebug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _model():
    return build_depth_model("vitt", 20.0, torch.float32, device="cpu")


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(1, 56, 56, 3)).astype(
        np.float32))


def _poison(model):
    with torch.no_grad():
        model.pretrained.blocks[2].attn.qkv.weight[5, 3] = float("nan")


def test_forward_nan_raises_naming_the_op_and_module():
    model = _model()
    _poison(model)
    with pytest.raises(FloatingPointError,
                       match=r"nan_checks: aten\.\w+\.\w+ produced a NaN "
                             r"\(in pretrained\.blocks\.2\.attn\)"):
        with torch.no_grad(), tdebug.nan_checks():
            model(_image())
    # Off, the same forward runs through to a NaN map.
    with torch.no_grad():
        assert torch.isnan(model(_image())).any()


def test_kernel_ops_are_checked():
    """The kernels' ops are ops like any other: a NaN in q comes out of
    ``e3d::flash_attn_fwd`` and is caught there."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 8, 2, 32)
    k = v = torch.zeros(1, 8, 2, 32)
    nan_q = q.clone()
    nan_q[0, 3, 1, 0] = float("nan")
    with tdebug.nan_checks():
        fa.flash_attention(q, k, v)
        with pytest.raises(FloatingPointError, match="e3d.flash_attn_fwd"):
            fa.flash_attention(nan_q, k, v)


def _backward_nan(model):
    """A finite forward whose backward makes a NaN inside the model: the
    gradient of sqrt at 0 is inf, and inf times weights of both signs
    sums to NaN in the head's backward."""
    pred = model(_image(1))
    (torch.sqrt(pred - pred.detach())).sum().backward()


def test_backward_nan_raises():
    model = _model().train()
    with pytest.raises(FloatingPointError, match=r"nan_checks: aten\."):
        with tdebug.nan_checks():
            _backward_nan(model)
    model.zero_grad()
    _backward_nan(model)  # off: runs through
    assert any(torch.isnan(p.grad).any() for p in model.parameters()
               if p.grad is not None)


def test_state_is_restored_and_nests():
    nan = torch.tensor([float("nan")])
    assert _get_current_dispatch_mode() is None
    with tdebug.nan_checks():
        with tdebug.nan_checks(False):
            nan + 1  # off inside an enabled block
            with tdebug.nan_checks(True):
                with pytest.raises(FloatingPointError):
                    nan + 1
            nan * 2
        with pytest.raises(FloatingPointError, match="aten.add"):
            nan + 1
        torch.empty(3)  # uninitialised memory is no computed NaN
    assert tdebug._STATE == {"enabled": False, "modes": 0}
    assert _get_current_dispatch_mode() is None
    nan + 1
    with pytest.raises(RuntimeError):
        with tdebug.nan_checks():
            raise RuntimeError("inside")
    assert tdebug._STATE == {"enabled": False, "modes": 0}
    assert _get_current_dispatch_mode() is None


def test_train_depth_with_debug_nans(tmp_path, monkeypatch):
    """``trainer.debug_nans=true``: the fit runs under the checks (a
    finite run raises nothing)."""
    entered = []
    real = tdebug.nan_checks

    def spy(enable=True):
        entered.append(enable)
        return real(enable)

    monkeypatch.setattr(tdebug, "nan_checks", spy)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    make_simcol_fixture(str(tmp_path / "simcol"), n_procedures=3,
                        frames_per_proc=4, hw=64, seed=2)
    s = tmp_path / "simcol"
    out = ttrain.main([
        "--device", "cpu", f"dataset.data_dir={s}",
        f"dataset.train_list={s}/train.txt", f"dataset.val_list={s}/val.txt",
        f"dataset.test_list={s}/test.txt", "dataset.batch_size=2",
        "dataset.num_workers=2", "dataset.size=56", "model.encoder=vitt",
        "trainer.precision=32-true", "model.use_checkpoint=false",
        "trainer.max_epochs=1", "trainer.accumulate_grad_batches=1",
        "++trainer.max_steps=1", "++trainer.debug_nans=true"])
    assert entered == [True]
    with open(tmp_path / out["run_dir"] / "metrics.jsonl",
              encoding="utf-8") as f:
        losses = [json.loads(line).get("train_loss") for line in f]
    assert [x for x in losses if x is not None] and all(
        np.isfinite(x) for x in losses if x is not None)
