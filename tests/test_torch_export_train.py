"""The port's exported depth training step (``serving/export.py``:
``export_train_step``, ``load_exported_train_step``) on the CPU, against
the port's live ``DepthTask.train_step`` and the JAX package's.

One vitt export at 56 px, f32, microbatch 2, grad-accum 2, gradient
checkpointing on, is shared by the file, its task that of the JAX
pairing (``tests/test_torch_depth_task.py``, ``_pair``), its batch
holding the per-sample ``max_depth`` and per-microbatch ``weight``
(``with_max_depth``, ``with_weight``). Batches of the full ``max_depth``
and unit weights take the plain step's arithmetic; the export without
them is held to the live step by ``tests/test_torch_export.py``'s
``export_model --train`` case. On the CPU every kernel op is its plain
version and the replay runs the eager step's ops in its order, so it
equals the live step bit for bit; it is held to the JAX package's own
replay bound, rtol 1e-6 and atol 1e-7 (``tests/test_export.py``), in
every metric, parameter and AdamW moment. Against the JAX package's live
step it is held to the one-step rules of
``tests/test_torch_depth_task.py``.

The file runs on one intra-op thread: the exports' time is the host's
Python, which threads do not share.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving import export as texport
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.optim import FunctionalClippedAdamW
from tests.test_torch_depth_task import (HW, TASK_ARGS, _batches, _jax_grad_fn,
                                         _pair, _step_both)

ACCUM, MB, TOTAL_STEPS = 2, 2, 4
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _task(**kw) -> DepthTask:
    return DepthTask(total_steps=TOTAL_STEPS, grad_accum=ACCUM,
                     policy=POLICY_F32, grad_checkpoint=True, device="cpu",
                     **TASK_ARGS, **kw)


@pytest.fixture(scope="module")
def plain(_one_thread, tmp_path_factory):
    task = _task()
    out = tmp_path_factory.mktemp("train")
    path = str(out / "vitt_train.pt2")
    meta = texport.export_train_step(task, task.init_state(0), path, MB,
                                     (HW, HW), with_max_depth=True,
                                     with_weight=True)
    # The fresh process of ``test_a_fresh_process_replays_the_artifact``
    # starts now and runs beside the JAX task's compiles and the file's
    # other tests. The artifact holds no weights, so the JAX pairing's
    # port state (``_pair``'s) replays it as any state of the task does.
    fresh = _start_fresh_replay(path, out)
    jtask, jstate, _, _, _ = _pair(TOTAL_STEPS, ACCUM, grad_checkpoint=True)
    yield {"jtask": jtask, "jstate": jstate, "task": task, "path": path,
           "meta": meta, "prog": texport.load_exported_train_step(path),
           "fresh": (fresh, out)}
    if fresh.poll() is None:
        fresh.kill()
        fresh.wait()


def _batch(seed: int = 0) -> dict:
    """A seeded batch of the full ``max_depth`` and unit weights: the
    plain step's."""
    images, depths = _batches(1, ACCUM, MB, seed=seed)
    return {"image": images[0], "depth": depths[0, ..., None],
            "max_depth": np.full((ACCUM, MB), 20.0, np.float32),
            "weight": np.ones(ACCUM, np.float32)}


def _moments(state) -> dict:
    opt = state.optimizer.optimizer
    return {(k, i): opt.state[p][k]
            for i, p in enumerate(state.optimizer.params)
            for k in ("exp_avg", "exp_avg_sq")}


def _assert_same(got_state, got_m, want_state, want_m) -> None:
    """Every metric, parameter and AdamW moment within the replay bound,
    the steps and the AdamW step counts equal."""
    assert set(got_m) == set(want_m) == {"loss", "d1", "abs_rel", "rmse",
                                         "l1"}
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), v.item(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    got_p = dict(got_state.model.named_parameters())
    for name, p in want_state.model.named_parameters():
        np.testing.assert_allclose(got_p[name].detach().numpy(),
                                   p.detach().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    got_o = _moments(got_state)
    for key, v in _moments(want_state).items():
        np.testing.assert_allclose(got_o[key].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=str(key))
    assert got_state.step == want_state.step
    opt_got = got_state.optimizer.optimizer
    opt_want = want_state.optimizer.optimizer
    for p, q in zip(got_state.optimizer.params, want_state.optimizer.params):
        assert float(opt_got.state[p]["step"]) == float(
            opt_want.state[q]["step"]) == got_state.step
    assert [g["lr"] for g in opt_got.param_groups] == [
        g["lr"] for g in opt_want.param_groups]


def test_replay_equals_the_live_step(plain):
    task, prog = plain["task"], plain["prog"]
    replayed, live = task.init_state(1), task.init_state(1)
    batch = _batch()
    replayed, got = prog(replayed, batch)
    live, want = task.train_step(live, batch)
    assert replayed.step == 1
    _assert_same(replayed, got, live, want)


def test_replay_then_eager_equals_two_eager_steps(plain):
    """An eager step follows a replayed one (the replay leaves AdamW's
    own state), and a replay follows it again."""
    task, prog = plain["task"], plain["prog"]
    mixed, live = task.init_state(2), task.init_state(2)
    for s, step in enumerate((prog, task.train_step, prog)):
        mixed, got = step(mixed, _batch(s))
        live, want = task.train_step(live, _batch(s))
        _assert_same(mixed, got, live, want)
    assert mixed.step == 3


def test_a_step_past_the_schedule_table(plain):
    """The table runs past the schedule's end until the bias corrections
    round to 1; a later step reads its last row, which is what the eager
    step computes there."""
    task, prog = plain["task"], plain["prog"]
    far, live = task.init_state(3), task.init_state(3)
    rows = FunctionalClippedAdamW(far.optimizer,
                                  TOTAL_STEPS).table.shape[0]
    assert rows > TOTAL_STEPS
    far, _ = task.train_step(far, _batch(1))
    live.load_state_dict(copy.deepcopy(far.state_dict()))
    for state in (far, live):
        state.step = rows + 7
        for s in state.optimizer.optimizer.state.values():
            s["step"] = torch.tensor(float(rows + 7))
    far, got = prog(far, _batch(2))
    live, want = task.train_step(live, _batch(2))
    _assert_same(far, got, live, want)


@pytest.mark.parametrize("chunk", [None, 4096])
def test_functional_step_equals_train_step(chunk, monkeypatch):
    """The untraced functional step (``FunctionalDepthStep``, flat AdamW
    chunks) against ``train_step``, bit for bit, with vitt's groups in one
    chunk each and cut into chunks of at most 4096 elements."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train import optim

    if chunk is not None:
        monkeypatch.setattr(optim, "CHUNK_ELEMENTS", chunk)
    task = _task()
    state, live = task.init_state(8), task.init_state(8)
    step = task.functional_train_step(state)
    params = [p.detach() for p in state.optimizer.params]
    spans = [params[lo:hi] for lo, hi, _ in step.optimizer.chunks]
    assert (len(spans) > 2) == (chunk is not None)
    assert all(sum(p.numel() for p in ps) <= (chunk or optim.CHUNK_ELEMENTS)
               or len(ps) == 1 for ps in spans)
    zeros = [torch.zeros(sum(p.numel() for p in ps)) for ps in spans]
    batch = {k: torch.from_numpy(v) for k, v in _batch(9).items()}
    new_p, new_m, new_v, count, got = step(
        params, zeros, [z.clone() for z in zeros], torch.tensor(0), batch)
    live, want = task.train_step(live, batch)
    assert int(count) == live.step == 1
    assert {k: v.item() for k, v in got.items()} == {
        k: v.item() for k, v in want.items()}
    opt = live.optimizer.optimizer
    for (lo, hi, _), p_new, m_new, v_new in zip(step.optimizer.chunks,
                                                 new_p, new_m, new_v):
        qs = live.optimizer.params[lo:hi]
        assert torch.equal(p_new, optim.flatten([q.detach() for q in qs]))
        for key, got_t in (("exp_avg", m_new), ("exp_avg_sq", v_new)):
            assert torch.equal(got_t, optim.flatten(
                [opt.state[q][key] for q in qs])), key


@pytest.mark.parametrize("case", ["max_depth", "zero_weight"])
def test_max_depth_and_weight(plain, case):
    """A per-sample max_depth; a zero-weight microbatch (a trailing
    group's pad, here of non-finite images), which both steps skip."""
    task, prog = plain["task"], plain["prog"]
    batch = _batch(4)
    batch["max_depth"] = np.asarray([[12.0, 20.0], [8.0, 20.0]], np.float32)
    if case == "zero_weight":
        batch["weight"][1] = 0.0
        batch["image"][1] = np.nan
    replayed, live = task.init_state(4), task.init_state(4)
    replayed, got = prog(replayed, batch)
    live, want = task.train_step(live, batch)
    assert all(np.isfinite(v.item()) for v in got.values())
    _assert_same(replayed, got, live, want)


def test_fixed_shape_manifest_and_device_guards(plain, monkeypatch):
    task, prog = plain["task"], plain["prog"]
    state = task.init_state(5)
    batch = _batch()
    small = {**batch, "image": batch["image"][:, :, :48, :48],
             "depth": batch["depth"][:, :, :48, :48]}
    with pytest.raises(ValueError, match="fixed-shape.*image"):
        prog(state, small)
    with pytest.raises(ValueError, match="fixed-shape.*weight missing"):
        prog(state, {k: v for k, v in batch.items() if k != "weight"})
    with pytest.raises(ValueError, match="fixed-shape.*max_depth \\[2\\]"):
        prog(state, {**batch, "max_depth": batch["max_depth"][0]})
    manifest = dict(prog.meta["state_manifest"])
    manifest.pop("model.pretrained.cls_token")
    monkeypatch.setitem(prog.meta, "state_manifest", manifest)
    with pytest.raises(ValueError, match="manifest"):
        prog(state, batch)
    monkeypatch.undo()
    monkeypatch.setitem(prog.meta, "platforms", ["cuda"])
    with pytest.raises(ValueError, match=r"traced on \['cuda'\].*cpu"):
        prog(state, batch)
    monkeypatch.undo()
    # AdamW's step must be the state's, for some parameters or none.
    state, _ = task.train_step(state, batch)
    state.step = 7
    with pytest.raises(ValueError, match="AdamW step"):
        prog(state, batch)
    state.step = 1
    state.optimizer.optimizer.state.pop(state.optimizer.params[0])
    with pytest.raises(ValueError, match="some parameters"):
        prog(state, batch)
    assert state.step == 1


@pytest.mark.parametrize("what", ["distill", "token_merge", "quant_int8"])
def test_the_functional_step_refuses_what_it_does_not_trace(what):
    task = _task(distill_encoder="vitt") if what == "distill" else _task()
    state = task.init_state(0)
    if what == "token_merge":
        state.model.pretrained.token_merge = 0.3
    if what == "quant_int8":
        state.model.quant_int8 = True
    want = {"distill": "distillation teacher"}.get(what, what)
    with pytest.raises(ValueError, match=f"single-card step.*{want}"):
        task.functional_train_step(state)


def test_artifact_holds_no_parameter_or_moment(plain):
    """The parameters and moments stay call-time inputs: no state, no
    example inputs, no constant shaped as a parameter or a group's flat
    moments."""
    prog = plain["prog"]
    state = plain["task"].init_state(0)
    params = state.optimizer.params
    shapes = {tuple(p.shape) for p in params}
    shapes |= {(sum(p.numel() for p in params[lo:hi]),)
               for lo, hi, _ in prog.meta["chunks"]}
    assert set(prog.programs) == {"microbatch", "update"}
    for ep in prog.programs.values():
        assert ep.example_inputs is None
        for name, t in {**ep.constants, **ep.state_dict}.items():
            assert tuple(t.shape) not in shapes, name
    assert plain["meta"]["artifact_bytes"] == os.path.getsize(plain["path"])


def test_sidecar(plain):
    with open(plain["path"] + ".json", encoding="utf-8") as f:
        on_disk = json.load(f)
    assert on_disk == plain["meta"]
    assert set(on_disk) == {
        "kind", "format", "programs", "encoder", "max_depth", "min_depth",
        "with_max_depth", "with_weight", "grad_accum", "microbatch",
        "image_hw", "total_steps", "schedule", "platforms", "dtype",
        "grad_checkpoint", "forward_schedule", "backward", "kernel_nodes",
        "group_sizes", "chunks", "graph_nodes", "artifact_bytes",
        "seconds", "state_manifest"}
    assert on_disk["programs"] == ["microbatch", "update"]
    assert on_disk["kind"] == "depth_train_step"
    assert on_disk["format"] == "torch.export"
    assert (on_disk["encoder"], on_disk["platforms"]) == ("vitt", ["cpu"])
    assert (on_disk["grad_accum"], on_disk["microbatch"],
            on_disk["image_hw"]) == (ACCUM, MB, [HW, HW])
    assert on_disk["total_steps"] == TOTAL_STEPS
    assert (on_disk["forward_schedule"], on_disk["backward"]) == ("plain",
                                                                  "plain")
    # vitt: 4 blocks, each run and recomputed in the microbatch program.
    assert on_disk["kernel_nodes"] == {"flash_attn_fwd": 2 * 4,
                                       "flash_attn_bwd": 4,
                                       "lerp_resize": 0}
    state = plain["task"].init_state(0)
    names = dict((id(p), n) for n, p in state.model.named_parameters())
    manifest = on_disk["state_manifest"]
    assert len(manifest) == 3 * len(names) + 1 and manifest["step"] == [
        [], "int64"]
    for p in state.optimizer.params:
        for kind in ("model", "exp_avg", "exp_avg_sq"):
            assert manifest[f"{kind}.{names[id(p)]}"] == [list(p.shape),
                                                           "float32"]
    assert sum(on_disk["group_sizes"]) == len(names)
    # Chunks tile the parameter list, each inside one group.
    ends = np.cumsum(on_disk["group_sizes"]).tolist()
    assert [c[0] for c in on_disk["chunks"]][0] == 0
    assert on_disk["chunks"][-1][1] == len(names)
    for (lo, hi, g), nxt in zip(on_disk["chunks"],
                                on_disk["chunks"][1:] + [[len(names)]]):
        assert lo < hi == nxt[0] and hi <= ends[g]
        assert lo >= ([0] + ends)[g]
    assert (on_disk["with_max_depth"], on_disk["with_weight"]) == (True,
                                                                 True)


def _start_fresh_replay(path: str, out) -> subprocess.Popen:
    """A process that imports nothing of the port's ops, loads the
    artifact at ``path`` and replays one step of ``_batch(6)`` on a seeded
    state, saving the state and metrics to ``out / "out.pt"``."""
    np.savez(out / "batch.npz", **_batch(6))
    code = (
        "import sys, numpy as np, torch\n"
        "from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
        "depth_and_pose_estimation_tpu_torch.serving import export\n"
        "assert not any(m.endswith('.ops.flash_attention') "
        "for m in sys.modules)\n"
        "from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
        "depth_and_pose_estimation_tpu_torch.core.dtypes import "
        "POLICY_F32\n"
        "from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
        "depth_and_pose_estimation_tpu_torch.train.depth_task import "
        "DepthTask\n"
        "torch.set_num_threads(1)\n"
        f"prog = export.load_exported_train_step({path!r})\n"
        f"batch = dict(np.load({str(out / 'batch.npz')!r}))\n"
        f"task = DepthTask(total_steps={TOTAL_STEPS}, grad_accum={ACCUM}, "
        f"policy=POLICY_F32, device='cpu', **{TASK_ARGS!r})\n"
        "state, m = prog(task.init_state(6), batch)\n"
        f"torch.save((state.state_dict(), m), {str(out / 'out.pt')!r})\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            env=dict(os.environ, PYTHONPATH=root))


def test_a_fresh_process_replays_the_artifact(plain):
    """``load_exported_train_step`` registers the kernel ops before the
    program loads: a process that imported nothing of the port's ops
    replays it, and its step is the live one's."""
    fresh, out = plain["fresh"]
    assert fresh.wait(timeout=120) == 0
    got_sd, got_m = torch.load(out / "out.pt")
    task = plain["task"]
    replayed, live = task.init_state(0), task.init_state(6)
    replayed.load_state_dict(got_sd)
    live, want = task.train_step(live, _batch(6))
    _assert_same(replayed, got_m, live, want)


def test_replay_matches_the_jax_live_step(plain):
    """From the JAX state, through ``from_jax_params``, the replayed step
    against the JAX package's live ``DepthTask.train_step``: the loss and
    metrics within 2e-4 relative, the gradients and parameters by
    ``_step_both``'s rules."""
    ttask = plain["task"]
    tstate = ttask.init_state(0)
    batch = _batch(7)
    jstate, jm, tstate, tm = _step_both(
        plain["jtask"], plain["jstate"], ttask, tstate, batch,
        _jax_grad_fn(plain["jtask"]), tstep=plain["prog"])
    assert tstate.step == int(jstate.step) == 1
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("dial", [["--int8"], ["--token-merge", "0.3"]])
def test_export_model_train_refuses_the_dials(dial, tmp_path):
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import export_model

    out = tmp_path / "t.pt2"
    with pytest.raises(SystemExit, match="does not compose with the "
                       "inference speed dials"):
        export_model.main(["--train", "--device", "cpu", "--encoder",
                           "vitt", "-o", str(out), *dial])
    assert not out.exists()
