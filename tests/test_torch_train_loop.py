"""The port's ``fit_depth`` on an in-memory datamodule (vitt, CPU):
checkpoints, resume, ``max_steps``, trailing groups, logging, and the
checkpoint manager and early stopping it relies on."""

import json
import os

import numpy as np
import pytest
import torch

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.checkpoint import CheckpointManager, EarlyStopping
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import debug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.debug import profile_trace
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.metrics import MetricBank
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train import loop
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask


class MemoryData:
    """Seeded uint8 frames and uint16 depth, ``n`` batches of ``mb``."""

    size = 56

    def __init__(self, n: int, mb: int = 2, hw=(60, 64), seed: int = 0,
                 combined: bool = False):
        rng = np.random.default_rng(seed)
        self.batches = [
            {"image": rng.integers(0, 256, (mb, *hw, 3), dtype=np.uint8),
             "depth": rng.integers(0, 65536, (mb, *hw), dtype=np.uint16)}
            for _ in range(n)]
        if combined:
            for b in self.batches:
                b["source"] = np.arange(mb) % 2
        self.train_dataset = None

    def setup(self, stage: str) -> None:
        self.train_dataset = self.batches

    def train_loader(self):
        return self.batches

    def val_loader(self):
        return self.batches[:2]


def _task(total_steps=4, accum=2, **kw) -> DepthTask:
    return DepthTask("vitt", encoder_lr=1e-3, decoder_lr=1e-3,
                     div_factor=25.0, total_steps=total_steps,
                     grad_accum=accum, device="cpu", **kw)


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_fit_writes_checkpoints_logs_and_stops_at_max_steps(tmp_path):
    data = MemoryData(6)
    state = loop.fit_depth(_task(), data, max_epochs=5,
                           log_dir=str(tmp_path / "log"),
                           ckpt_dir=str(tmp_path / "ckpt"), max_steps=2,
                           val_check_interval=1.0)
    assert state.step == 2 and data.train_dataset is data.batches
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2
    assert os.path.exists(tmp_path / "ckpt" / "2" / "state.pt")
    records = _records(tmp_path / "log")
    train = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in train)
    assert [r["step"] for r in records if "val_loss" in r] == [2]
    assert any("Train/epoch_loss" in r for r in records)
    assert any("perf/steps_per_s" in r and "perf/loader_wait_s" in r
               for r in records)


def test_trailing_group_is_padded_with_zero_weights(tmp_path, monkeypatch):
    task = _task(total_steps=3)
    seen = []
    step = task.train_step

    def spy(state, batch):
        seen.append((tuple(batch["image"].shape), batch["weight"].tolist()))
        return step(state, batch)

    monkeypatch.setattr(task, "train_step", spy)
    state = loop.fit_depth(task, MemoryData(5), max_epochs=1,
                           log_dir=str(tmp_path / "log"),
                           ckpt_dir=str(tmp_path / "ckpt"))
    assert state.step == 3
    assert [w for _, w in seen] == [[1.0, 1.0], [1.0, 1.0], [1.0, 0.0]]
    assert all(shape == (2, 2, 56, 56, 3) for shape, _ in seen)
    # 3 steps an epoch, validation every int(3 * 0.5) = 1 step.
    assert len([r for r in _records(tmp_path / "log")
                if "val_loss" in r]) == 3


def test_resume_restores_step_moments_and_early_stopping(tmp_path):
    kw = dict(log_dir=str(tmp_path / "log"), ckpt_dir=str(tmp_path / "ckpt"),
              val_check_interval=1.0)
    first = loop.fit_depth(_task(), MemoryData(4), max_epochs=1,
                           max_steps=2, **kw)
    params = {k: v.clone() for k, v in first.model.state_dict().items()}
    moments = first.optimizer.state_dict()["state"]
    resumed = loop.fit_depth(_task(), MemoryData(4), max_epochs=0,
                             resume=True, **kw)
    assert resumed.step == 2
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    got = resumed.optimizer.state_dict()["state"]
    assert got.keys() == moments.keys()
    for i in moments:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(got[i][name], moments[i][name],
                                       rtol=0, atol=0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    val = [r["val_loss"] for r in _records(tmp_path / "log")
           if "val_loss" in r]
    stopper = EarlyStopping(patience=5)
    loop._restore_stopper(stopper, ckpt)
    assert stopper.best == pytest.approx(min(val))
    assert stopper.bad_count == (0 if val[-1] <= min(val) else 1)
    more = loop.fit_depth(_task(), MemoryData(4), max_epochs=1, max_steps=3,
                          resume=True, **kw)
    assert more.step == 3


def test_combined_batches_validate_per_source(tmp_path):
    state = loop.fit_depth(_task(), MemoryData(2, combined=True),
                           max_epochs=1, log_dir=str(tmp_path / "log"),
                           ckpt_dir=str(tmp_path / "ckpt"),
                           max_depths=(20.0, 10.0), max_steps=1)
    assert state.step == 1
    val = [r for r in _records(tmp_path / "log") if "val_loss" in r][0]
    for src in ("SimCol", "C3VD"):
        for metric in ("l1", "rmse", "abs_rel", "d1"):
            assert np.isfinite(val[f"Val/val_{src}/{metric}"])


def test_group_accum_yields_the_trailing_group():
    groups = list(loop._group_accum(iter(range(7)), 3))
    assert groups == [[0, 1, 2], [3, 4, 5], [6]]


def test_checkpoint_manager_keeps_best_and_latest(tmp_path):
    class State:
        def __init__(self, x):
            self.x = x

        def state_dict(self):
            return {"x": torch.tensor(self.x)}

        def load_state_dict(self, sd):
            self.x = float(sd["x"])

    ckpt = CheckpointManager(str(tmp_path), max_to_keep=1)
    assert ckpt.latest_step() is None and ckpt.restore_latest(State(0)) is None
    ckpt.save(1, State(1.0), {"val_loss": 0.5, "es_bad_count": 0})
    ckpt.save(2, State(2.0), {"val_loss": 0.7, "es_bad_count": 1})
    # Step 1 stays the best by val_loss; step 2 lives in the latest/ slot.
    assert sorted(os.listdir(tmp_path)) == ["1", "latest"]
    assert sorted(os.listdir(tmp_path / "latest")) == ["2", "metrics.json"]
    assert ckpt.latest_step() == 2
    assert ckpt.latest_metrics() == {"val_loss": 0.7, "es_bad_count": 1.0}
    assert ckpt.restore_latest(State(0)).x == 2.0
    ckpt.save(3, State(3.0), {"val_loss": 0.1})
    # Step 3 is the new best, kept once, and the stale latest/2 is gone.
    assert sorted(os.listdir(tmp_path)) == ["3", "latest"]
    assert os.listdir(tmp_path / "latest") == ["metrics.json"]
    assert ckpt.latest_step() == 3 and ckpt.latest_metrics() == {
        "val_loss": 0.1}
    assert ckpt.restore_latest(State(0)).x == 3.0


def test_early_stopping_counts_patience():
    stopper = EarlyStopping(patience=2)
    assert [stopper.update(v) for v in (1.0, 0.5, 0.6, 0.4, 0.7, 0.8)] == [
        False, False, False, False, False, True]
    assert stopper.best == 0.4 and stopper.bad_count == 2


def test_metric_bank_and_step_timer(tmp_path):
    bank = MetricBank.zeros(("loss", "d1"))
    bank = MetricBank.update(bank, {"loss": torch.tensor(2.0)})
    bank = MetricBank.update(bank, {"loss": torch.tensor(4.0),
                                    "d1": torch.tensor(1.0)}, weight=3.0)
    means = MetricBank.compute(bank)
    assert means["loss"].item() == pytest.approx(3.5)
    assert means["d1"].item() == pytest.approx(1.0)
    # The loops' step statistics, over every ``train.step`` span given.
    assert debug.step_stats([]) == {}
    steps = [debug.Span("train.step", k, start_ns=0, end_ns=ns)
             for k, ns in enumerate((1_000_000, 2_000_000, 6_000_000))]
    stats = debug.step_stats(steps)
    assert stats["step_time_mean_s"] == pytest.approx(3e-3)
    assert stats["step_time_p50_s"] == pytest.approx(2e-3)
    assert stats["steps_per_s"] == pytest.approx(1 / 3e-3)
    with debug.span("train.step") as s:
        pass
    assert debug.step_stats([s])["steps_per_s"] > 0
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
