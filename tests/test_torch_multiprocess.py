"""The port's multi-process input path: ``cli.train_depth`` (``fit_depth``)
and ``cli.test_depth`` on two gloo CPU processes against one process, and
SIGTERM to rank 0 alone.

Two processes split every global batch of 2 (one row each; the test set's
trailing batch of 1 is replicated and split 0/1); the augmentation draws
are the global batch's, the loss is the global batch's, so the logged
losses are the one-process run's. ``test_depth``'s per-sample metrics are
gathered and sliced so that each sample is counted exactly once over the
ranks' result files.

Tolerances (fixed before the runs): the logged train and validation
losses within rtol 1e-5 of the one-process run; every test sample's
metrics within rtol 1e-3 (they come from parameters two Adam steps away,
in which elements whose gradient is at rounding level may have moved
either way), each sample counted once.
"""

import json
import os

import numpy as np
import pytest

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import test_depth as ttest
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import train_depth as ttrain
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from tests._torch_dist_worker import one_thread, start

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two procedures of 7 frames: 3 training batches of 2; the test
    procedure's 7 frames in 3 batches of 2 and a trailing 1."""
    return make_simcol_fixture(str(tmp_path_factory.mktemp("mp")),
                               n_procedures=2, frames_per_proc=7, hw=64,
                               seed=6)


def _argv(root):
    return [f"dataset.data_dir={root}",
            f"dataset.train_list={root}/train.txt",
            f"dataset.val_list={root}/val.txt",
            f"dataset.test_list={root}/test.txt",
            "dataset.batch_size=2", "dataset.num_workers=1",
            "dataset.size=56", "model.encoder=vitt",
            "trainer.precision=32-true", "trainer.max_epochs=1",
            "trainer.accumulate_grad_batches=1", "++trainer.max_steps=2",
            "--device", "cpu"]


def _records(cwd, run_dir):
    with open(os.path.join(cwd, run_dir, "metrics.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_two_processes_match_one(data, tmp_path, monkeypatch):
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    two_cwd = tmp_path / "two"
    two_cwd.mkdir()
    monkeypatch.setenv("E3D_RESULTS_DIR", str(two_cwd / "results"))
    two = start("cli", 2, str(tmp_path / "w"), {
        "cwd": str(two_cwd),
        "train_argv": _argv(data) + ["++trainer.distributed=true"],
        "test_argv": _argv(data) + ["++trainer.distributed=true"]})

    one_cwd = tmp_path / "one"
    one_cwd.mkdir()
    monkeypatch.chdir(one_cwd)
    monkeypatch.setenv("E3D_RESULTS_DIR", str(one_cwd / "results"))
    with one_thread():
        run = ttrain.main(_argv(data))
        monkeypatch.setenv("CHECKPOINT_PATH", run["ckpt_dir"])
        single = ttest.main(_argv(data))
    ranks = two()

    # Training: the same logged losses (rank 0 logs, rank 1 writes none).
    want = _records(one_cwd, run["run_dir"])
    got = _records(two_cwd, ranks[0]["run"]["run_dir"])
    for key in ("train_loss", "val_loss"):
        w = [r[key] for r in want if key in r]
        g = [r[key] for r in got if key in r]
        assert len(w) == len(g) > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=key)
    assert os.path.exists(two_cwd / ranks[0]["run"]["ckpt_dir"] / "2" /
                          "state.pt")

    # Testing: each rank wrote its rows; together every sample once.
    files = sorted(os.listdir(two_cwd / "results"))
    assert files == ["simcol_results_p0.json", "simcol_results_p1.json"]
    merged = {}
    for r in ranks:
        for proc, metrics in r["results"]["samples"].items():
            for k, v in metrics.items():
                merged.setdefault(proc, {}).setdefault(k, []).extend(v)
    assert sorted(merged) == sorted(single["samples"])
    for proc, metrics in single["samples"].items():
        for k, v in metrics.items():
            assert len(merged[proc][k]) == len(v) == 7, (proc, k)
            np.testing.assert_allclose(sorted(merged[proc][k]), sorted(v),
                                       rtol=1e-3, err_msg=k)


def test_sigterm_to_rank_zero_stops_both_ranks(tmp_path):
    """Rank 0 SIGTERMs itself while its loader yields batch 3 (of 6 a
    epoch, validation every 3 steps); the ranks agree at the next step
    boundary, stop at step 4 together, rank 0 writes the one ``latest/``,
    both exit 0, and a two-rank resume continues to ``max_steps``."""
    fixture = make_simcol_fixture(str(tmp_path / "data"), n_procedures=2,
                                  frames_per_proc=12, hw=64, seed=4)
    ckpt_dir = str(tmp_path / "ckpt")
    inputs = {"kind": "depth", "fixture": fixture, "dir": str(tmp_path),
              "ckpt_dir": ckpt_dir, "max_steps": 100, "resume": False,
              "patience": 20, "fire_at": 3}
    first = [r[0] for r in start("preempt", 2, str(tmp_path / "w1"),
                                 {"runs": [inputs]})()]
    assert [r["step"] for r in first] == [4, 4]
    assert [r["latest_step"] for r in first] == [4, 4]
    assert all(r["metrics"]["preempted"] == 1.0 for r in first)
    assert sorted(os.listdir(os.path.join(ckpt_dir, "latest"))) == [
        "4", "metrics.json"]
    second = [r[0] for r in start(
        "preempt", 2, str(tmp_path / "w2"),
        {"runs": [{**inputs, "max_steps": 5, "resume": True,
                   "dir": str(tmp_path / "r")}]})()]
    assert [r["step"] for r in second] == [5, 5]
    assert all("preempted" not in r["metrics"] for r in second)
