"""The port's preemption guard (``core/preempt.py``) and the fit loops'
handling of SIGTERM (``train/loop.py``), one process without a process
group.

``fit_depth`` and then ``fit_pose`` run in a subprocess (the signal
handlers need the main thread) on a SimCol fixture; the process SIGTERMs
itself while each fit's loader yields batch 3, so step 4 trains, and the
fit then saves ``latest/`` at step 4 (``preempted`` 1, ``val_loss`` 1e30,
the early-stopping state of the validation at step 3) and returns, and
the process exits 0. A second process resumes each from step 4 to
``max_steps`` 6, keeping the patience counter.
"""

import json
import os
import signal
import time

import pytest

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.preempt import PreemptionGuard
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from tests._torch_dist_worker import start


def test_preemption_guard_latches_and_restores():
    """SIGTERM latches the flag (no exception), the handlers are restored
    on exit, and a second SIGINT raises ``KeyboardInterrupt``."""
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    with PreemptionGuard() as g:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)  # the handler runs at a bytecode boundary
        assert g.requested
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(0.01)  # a first Ctrl-C: the flag only
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.01)  # a second Ctrl-C: out at once
    assert signal.getsignal(signal.SIGTERM) is prev_term
    assert signal.getsignal(signal.SIGINT) is prev_int


def test_guard_in_a_worker_thread_is_never_requested():
    import threading

    seen = {}

    def run():
        with PreemptionGuard() as g:
            seen["requested"] = g.requested
            seen["installed"] = bool(g._prev)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen == {"requested": False, "installed": False}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return make_simcol_fixture(str(tmp_path_factory.mktemp("preempt")),
                               n_procedures=2, frames_per_proc=12, hw=64,
                               seed=4)


def _val_losses(log_dir: str) -> dict[int, float]:
    with open(os.path.join(log_dir, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    return {r["step"]: r["val_loss"] for r in records if "val_loss" in r}


KINDS = ("depth", "pose")


@pytest.fixture(scope="module")
def preempted(fixture, tmp_path_factory):
    """Both kinds' first runs in one process, their resumes in another:
    {kind: (its directory, first result, resumed result)}."""
    root = tmp_path_factory.mktemp("runs")
    runs = [{"kind": kind, "fixture": fixture, "dir": str(root / kind),
             "ckpt_dir": str(root / kind / "ckpt"), "max_steps": 100,
             "resume": False, "patience": 20, "fire_at": 3}
            for kind in KINDS]
    first = start("preempt", 1, str(root / "w1"), {"runs": runs})()[0]
    second = start("preempt", 1, str(root / "w2"), {"runs": [
        {**r, "max_steps": 6, "resume": True, "dir": r["dir"] + "/r"}
        for r in runs]})()[0]
    return {kind: (root / kind, a, b)
            for kind, a, b in zip(KINDS, first, second)}


@pytest.mark.parametrize("kind", KINDS)
def test_sigterm_saves_latest_and_resume_continues(preempted, kind):
    tmp_path, first, second = preempted[kind]
    assert first["step"] == 4 and first["latest_step"] == 4
    m = first["metrics"]
    assert m["preempted"] == 1.0 and m["val_loss"] == 1e30
    if kind == "depth":
        # The validation at step 3 (val_every 3) set the stopper.
        val3 = _val_losses(str(tmp_path / "logs0"))[3]
        assert m["es_best"] == pytest.approx(val3) and \
            m["es_bad_count"] == 0
        assert first["steps_saved"] == ["3"]
    else:
        # No validation yet: the stopper's state is empty, and the save
        # fills the empty best-k slot (the next validation displaces it).
        assert m["es_best"] == 1e30 and m["es_bad_count"] == 0
        assert first["steps_saved"] == ["4"]

    assert second["step"] == 6
    m2 = second["metrics"]
    assert "preempted" not in m2 and second["latest_step"] == 6
    if kind == "depth":
        val6 = _val_losses(str(tmp_path / "r" / "logs0"))[6]
        # The patience counter carried over from step 3's validation.
        assert m2["es_best"] == pytest.approx(min(val3, val6))
        assert m2["es_bad_count"] == (0 if val6 < val3 else 1)
        assert second["steps_saved"] == (["6"] if val6 < val3 else ["3"])
    else:
        assert second["steps_saved"] == ["6"]
