"""The port's ``DepthTask`` against the JAX package's, step by step.

Both tasks start from the same vitt weights (the JAX init, carried over
by ``models.convert.from_jax_params``) and take the same f32 batches: four
optimizer steps of SiLog + two-group AdamW + OneCycle + global-norm clip
over two accumulated microbatches, as ``tests/test_train_parity_torch.py``
lays out its torch comparison, with gradient checkpointing off and on, and
once with the JAX side on its fused Pallas attention path (kernels K1 and
K2 in interpret mode).

Each step starts both tasks from the same point: the port's model, Adam
moments and step count are loaded from the JAX state before it. Then the
step's loss agrees within 2e-4 relative, its weighted-mean gradient within
1e-2 in relative norm, and the parameters after it within 1e-4 absolute
wherever Adam's update is set by the gradient rather than by f32 noise.

Adam divides each gradient element by its own RMS, so an element whose
gradient the two frameworks do not agree on takes an update of up to the
learning rate that differs between them: a gradient at f32 noise level (a
key bias, which softmax ignores), or the elements upstream of a ReLU
whose input lies a few ulps from its kink, so that it opens in one
framework and not the other (the gradients then differ well beyond f32
rounding, but far inside the 1e-2 norm bound). The
rule: an element is left out when the two gradients differ by more than
``GRAD_REL`` of the reference's magnitude. From a common point the
moments agree, so a kept element's updates differ by at most about
lr * GRAD_REL * sqrt(step) (3e-3 * 1e-2 * 2 = 6e-5 for the decoder). The
rule reads only the step's own gradients, so it holds for any data seed;
the test also bounds the share of elements it leaves out, so that the
check never empties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.ops import attention as jattn
from e3d_tpu.train import DepthTask as JaxDepthTask
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_params
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import (
    DepthTask, _merge_params)

HW = 56
TASK_ARGS = dict(encoder="vitt", min_depth=1e-6, max_depth=20.0,
                 encoder_lr=1e-3, decoder_lr=3e-3, pct_start=0.3,
                 div_factor=25.0, clip_norm=1.0)


def _batches(n_steps, accum, mb, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n_steps, accum, mb, HW, HW, 3)).astype(
        np.float32)
    depths = rng.uniform(0.5, 18.0, (n_steps, accum, mb, HW, HW)).astype(
        np.float32)
    bad = rng.uniform(size=depths.shape)
    depths[bad < 0.05] = 0.0       # below min_depth
    depths[bad > 0.95] = 25.0      # above max_depth
    return images, depths


def _pair(total_steps, accum, grad_checkpoint, seed=0):
    jtask = JaxDepthTask(total_steps=total_steps, grad_accum=accum,
                         policy=J_F32, grad_checkpoint=grad_checkpoint,
                         **TASK_ARGS)
    with jax.default_matmul_precision("highest"):
        jstate = jtask.init_state(jax.random.PRNGKey(seed), (HW, HW))
    ttask = DepthTask(total_steps=total_steps, grad_accum=accum,
                      policy=POLICY_F32, grad_checkpoint=grad_checkpoint,
                      device="cpu", **TASK_ARGS)
    params0 = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    tstate = ttask.init_state(seed + 1, pretrained_params=params0)
    return jtask, jstate, ttask, tstate, params0


# Relative gradient disagreement past which an element's Adam update is
# noise (healthy elements agree to about 1e-6), and the share of elements
# the parameter check may leave out for it.
GRAD_REL = 1e-2
MAX_UNDETERMINED = 0.1


def _start_from(tstate, jstate) -> None:
    """Load the JAX state (parameters, both groups' Adam moments, step)
    into the port's, so that the next step starts from the same point."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    groups = jstate.opt_state[1].inner_states
    adam = [groups[g].inner_state[0] for g in ("encoder", "decoder")]

    def merged(field):
        enc, dec = (getattr(s, field) for s in adam)
        tree = jax.tree.map(lambda e, d: d if masked(e) else e, enc, dec,
                            is_leaf=masked)
        return from_jax_params(jax.tree.map(np.asarray, tree))

    mu, nu = merged("mu"), merged("nu")
    count = int(adam[0].count)
    assert count == int(adam[1].count) == int(jstate.step)
    model = tstate.model
    model.load_state_dict(
        {**model.state_dict(),
         **from_jax_params(jax.tree.map(np.asarray, jstate.params))})
    opt = tstate.optimizer.optimizer
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].clone(),
                        "exp_avg_sq": nu[name].clone()}
    tstate.step = count


def _jax_grad_fn(jtask):
    def loss(params, image, depth, max_depth):
        return jtask._loss_and_metrics(params, image, depth, max_depth,
                                       train=True)[0]

    return jax.jit(jax.grad(loss))


def _mean_grads(jgrad, jparams, ttask, tmodel, images, depths, maxd=None,
                weight=None) -> tuple[dict, dict]:
    """(port, reference) weighted-mean gradients of one (A, mb, ...) batch
    before clipping, each task at its own parameters (the same ones after
    ``_start_from``), by port name."""
    accum, mb = images.shape[:2]
    if maxd is None:
        maxd = np.full((accum, mb), ttask.max_depth, np.float32)
    if weight is None:
        weight = np.ones(accum, np.float32)
    inv = 1.0 / float(weight.sum())
    ref = None
    tmodel.zero_grad(set_to_none=True)
    with jax.default_matmul_precision("highest"):
        for a in range(accum):
            if weight[a] == 0:
                continue
            w = float(weight[a]) * inv
            g = jgrad(jparams, jnp.asarray(images[a]), jnp.asarray(depths[a]),
                      jnp.asarray(maxd[a]))
            g = jax.tree.map(lambda x: np.asarray(x) * w, g)
            ref = g if ref is None else jax.tree.map(np.add, ref, g)
            loss, _ = ttask._loss_and_metrics(
                tmodel, torch.from_numpy(images[a]),
                torch.from_numpy(depths[a]), torch.from_numpy(maxd[a]))
            (loss * w).backward()
    ref = from_jax_params(ref)
    got = {k: torch.zeros_like(v) for k, v in ref.items()}
    got.update({n: p.grad.detach().clone()
                for n, p in tmodel.named_parameters() if p.grad is not None})
    tmodel.zero_grad(set_to_none=True)
    return got, ref


def _check_grads(got, ref) -> None:
    err = torch.sqrt(sum(((got[k] - r) ** 2).sum() for k, r in ref.items()))
    norm = torch.sqrt(sum((r ** 2).sum() for r in ref.values()))
    assert norm > 0 and err <= 1e-2 * norm, (err.item(), norm.item())


def _undetermined(got, ref) -> dict[str, torch.Tensor]:
    """Elements whose gradient the two tasks disagree on."""
    return {k: (got[k] - r).abs() > GRAD_REL * r.abs()
            for k, r in ref.items()}


def _check_params(jparams, tmodel, undetermined) -> None:
    """Parameters within 1e-4 wherever the gradients agreed; the elements
    left out are few."""
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    got = tmodel.state_dict()
    assert set(want) <= set(got)
    left_out = total = 0
    for k, v in want.items():
        keep = ~undetermined[k]
        left_out += int((~keep).sum())
        total += keep.numel()
        delta = (got[k] - v).abs()[keep]
        assert delta.numel() == 0 or delta.max().item() < 1e-4, (
            k, delta.max().item())
    assert left_out <= MAX_UNDETERMINED * total, (left_out, total)


def _step_both(jtask, jstate, ttask, tstate, batch, jgrad, tstep=None):
    """One step of each task from the JAX state (the port's through
    ``tstep(state, batch)``, by default its ``train_step``); checks the
    gradients and the parameters after it, and returns both states and
    metrics."""
    _start_from(tstate, jstate)
    grads = _mean_grads(jgrad, jstate.params, ttask, tstate.model,
                        batch["image"], batch["depth"],
                        batch.get("max_depth"), batch.get("weight"))
    with jax.default_matmul_precision("highest"):
        jstate, jm = jtask.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = (tstep or ttask.train_step)(tstate, batch)
    _check_grads(*grads)
    _check_params(jstate.params, tstate.model, _undetermined(*grads))
    return jstate, jm, tstate, tm


@pytest.mark.parametrize("mode", ["plain", "remat", "jax-fused"])
def test_four_steps_match_jax(mode):
    n_steps, accum, mb = 4, 2, 2
    jtask, jstate, ttask, tstate, params0 = _pair(
        n_steps, accum, grad_checkpoint=mode != "plain")
    images, depths = _batches(n_steps, accum, mb)
    jgrad = _jax_grad_fn(jtask)
    losses, jax_losses = [], []
    jattn.set_force_fused(mode == "jax-fused")
    try:
        for s in range(n_steps):
            jstate, jm, tstate, tm = _step_both(
                jtask, jstate, ttask, tstate,
                {"image": images[s], "depth": depths[s]}, jgrad)
            jax_losses.append(float(jm["loss"]))
            losses.append(tm["loss"].item())
            assert set(tm) == {"loss", "d1", "abs_rel", "rmse", "l1"}
    finally:
        jattn.set_force_fused(False)
    assert tstate.step == n_steps
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    moved = max((tstate.model.state_dict()[k] - v).abs().max().item()
                for k, v in params0.items())
    assert moved > 1e-3, moved


def test_trailing_group_max_depth_and_eval_match_jax():
    """A trailing group (one real chunk, one zero-weight pad) with a
    per-sample max_depth steps on the real chunk alone; then eval_step."""
    jtask, jstate, ttask, tstate, _ = _pair(2, 2, grad_checkpoint=False,
                                            seed=3)
    images, depths = _batches(1, 2, 2, seed=4)
    images[0, 1], depths[0, 1] = images[0, 0], depths[0, 0]
    maxd = np.asarray([[12.0, 20.0], [12.0, 20.0]], np.float32)
    batch = {"image": images[0], "depth": depths[0], "max_depth": maxd,
             "weight": np.asarray([1.0, 0.0], np.float32)}
    jstate, jm, tstate, tm = _step_both(jtask, jstate, ttask, tstate, batch,
                                        _jax_grad_fn(jtask))
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    with jax.default_matmul_precision("highest"):
        jeval = jtask.eval_step(jstate.params,
                                {"image": jnp.asarray(images[0, 1]),
                                 "depth": jnp.asarray(depths[0, 1])})
    teval = ttask.eval_step(tstate.model, {"image": images[0, 1],
                                           "depth": depths[0, 1]})
    assert set(teval) == set(jeval)
    for k in jeval:
        np.testing.assert_allclose(teval[k].item(), float(jeval[k]),
                                   rtol=2e-4, err_msg=k)


def test_eval_step_combined_and_lr_table():
    jtask, jstate, ttask, tstate, _ = _pair(7, 2, grad_checkpoint=False,
                                            seed=5)
    images, depths = _batches(1, 1, 3, seed=6)
    batch = {"image": images[0, 0], "depth": depths[0, 0, ..., None] / 2.0,
             "max_depth": np.asarray([20.0, 10.0, 10.0], np.float32),
             "source": np.asarray([0, 1, 1], np.int32)}
    with jax.default_matmul_precision("highest"):
        want = jtask.eval_step_combined(
            jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttask.eval_step_combined(tstate.model, batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    jt, tt = jtask.lr_table(), ttask.lr_table()
    for name in ("encoder", "decoder"):
        np.testing.assert_allclose(tt[name], jt[name], rtol=0, atol=1e-9)


def test_merge_params_overlays_and_checks():
    ttask = DepthTask(encoder="vitt", device="cpu", policy=POLICY_F32)
    base = ttask.init_state(0).model.state_dict()
    name = "pretrained.blocks.0.attn.qkv.bias"
    overlay = {name: np.ones(base[name].shape, np.float64)}
    merged = _merge_params(base, overlay)
    assert merged[name].dtype == torch.float32 and bool(
        (merged[name] == 1).all())
    assert merged["depth_head.projects.0.bias"] is base[
        "depth_head.projects.0.bias"]
    with pytest.raises(KeyError, match="not a parameter"):
        _merge_params(base, {"pretrained.nope": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        _merge_params(base, {name: np.zeros(3)})
    # Encoder-only weights merge over the seeded init.
    state = ttask.init_state(0, pretrained_params=overlay)
    assert bool((state.model.state_dict()[name] == 1).all())
    assert state.model.training
