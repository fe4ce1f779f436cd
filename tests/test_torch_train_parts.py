"""The port's training parts against the JAX package's: SiLog and the depth
metrics, the OneCycle schedule, the two-group AdamW with global-norm clip
against optax, the augmentation ops and ``DevicePreprocessor``.

Inputs come from numpy seeds. The random draws of the augmentation are
made by the JAX package's own key splits and handed to the port's ops as
explicit values, since the two frameworks' random streams differ.

Tolerances, all f32: losses and metrics 1e-5 relative (sums in another
order); the schedule 1e-6 of its peak (the same f32 formula; XLA's
and numpy's cosines differ in the last bits); five optimizer
steps 1e-6 absolute on O(1) parameters (Adam's eps and f32 rounding);
colour ops 1e-5 on [0, 1] pixels (the HSV round trip); preprocessed images
2e-4 after the ImageNet division by std ~0.22.
"""

from time import perf_counter_ns

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import e3d_tpu  # noqa: F401
from e3d_tpu.data import preprocess as jpre
from e3d_tpu.evaluation import depth_metrics as jmetrics
from e3d_tpu.losses import silog as jsilog
from e3d_tpu.ops import augment as jaug
from e3d_tpu.train import optim as joptim
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.preprocess import DevicePreprocessor
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.evaluation.depth_metrics import compute_depth_errors
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.losses.silog import silog_loss
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import augment as taug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train import optim as toptim


def _depth_case(seed, shape=(2, 24, 30), masked_out=False):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.2, 19.0, shape).astype(np.float32)
    gt = rng.uniform(0.0, 25.0, shape).astype(np.float32)
    mask = (gt >= 1e-6) & (gt <= 20.0)
    if masked_out:
        mask[:] = False
    return pred, gt, mask


# ------------------------------------------------------ loss and metrics


@pytest.mark.parametrize("masked_out", [False, True],
                         ids=["mask", "all-masked"])
def test_silog_and_metrics_match_jax(masked_out):
    pred, gt, mask = _depth_case(0, masked_out=masked_out)
    tp, tg, tm = (torch.from_numpy(x) for x in (pred, gt, mask))
    loss = silog_loss(tp, tg, tm)
    expected = float(jsilog.silog_loss(pred, gt, mask))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), expected, rtol=1e-5)
    got = compute_depth_errors(tp, tg, tm)
    want = jmetrics.compute_depth_errors(pred, gt, mask)
    assert set(got) == set(want) == set(jmetrics.DEPTH_METRIC_NAMES)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert np.isfinite(got[k].item())


def test_silog_gradient_matches_jax():
    pred, gt, mask = _depth_case(1)
    tp = torch.from_numpy(pred).requires_grad_(True)
    silog_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask)).backward()
    expected = jax.grad(jsilog.silog_loss)(jnp.asarray(pred), gt, mask)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(expected),
                               rtol=1e-4, atol=1e-9)


def test_metrics_without_mask_match_jax():
    pred, gt, _ = _depth_case(2)
    got = compute_depth_errors(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.compute_depth_errors(pred, gt)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)


# ------------------------------------------------------------- schedule


@pytest.mark.parametrize("args", [(5e-6, 1000, 0.1, 1e9), (1e-3, 37, 0.3, 25.0),
                                  (5e-5, 4, 0.1, 1e9)])
def test_onecycle_schedule_matches_jax(args):
    max_lr, total, pct, div = args
    ours = toptim.onecycle_schedule(max_lr, total, pct, div)
    theirs = joptim.onecycle_schedule(max_lr, total, pct, div)
    steps = np.arange(total + 3)  # past the end, the last value holds
    want = np.asarray(jax.vmap(theirs)(steps))
    got = np.asarray([ours(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max_lr)


# ------------------------------------------------------------ optimizer


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"pretrained": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                           "mask_token": rng.normal(size=(3,)).astype(
                               np.float32)},
            "depth_head": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                           "b": rng.normal(size=(2,)).astype(np.float32)}}


def _module(tree) -> nn.Module:
    model = nn.Module()
    for group, leaves in tree.items():
        sub = nn.Module()
        for name, arr in leaves.items():
            setattr(sub, name, nn.Parameter(torch.from_numpy(arr.copy())))
        setattr(model, group, sub)
    return model


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3],
                         ids=["clip-active", "clip-inactive"])
def test_depth_optimizer_matches_optax(grad_scale):
    """Five steps of clip + 2-group AdamW + OneCycle on a two-group tree.
    ``pretrained.mask_token`` never gets a gradient: it decays only, as a
    zero-gradient optax leaf does."""
    lrs, sched = (1e-2, 3e-2), dict(total_steps=5, pct_start=0.3,
                                    div_factor=25.0)
    tree = _tree(0)
    model = _module(tree)
    opt = toptim.make_depth_optimizer(model, *lrs, clip_norm=1.0, **sched)
    jopt = joptim.make_depth_optimizer(tree, *lrs, clip_norm=1.0, **sched)
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(params)
    rng = np.random.default_rng(1)
    for step in range(5):
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * grad_scale).astype(
                np.float32), tree)
        grads["pretrained"]["mask_token"][:] = 0.0
        norm = np.sqrt(sum(float(np.sum(g ** 2))
                           for g in jax.tree.leaves(grads)))
        assert (norm > 1.0) == (grad_scale > 1.0)
        updates, state = jopt.update(jax.tree.map(jnp.asarray, grads), state,
                                     params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for name, p in model.named_parameters():
            group, leaf = name.split(".")
            if leaf != "mask_token":
                p.grad = torch.from_numpy(grads[group][leaf].copy())
        got_norm = opt.step(step)
        np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-5)
    for name, p in model.named_parameters():
        group, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[group][leaf]),
                                   atol=1e-6, err_msg=name)
        assert not np.allclose(p.detach().numpy(), tree[group][leaf])


def test_depth_optimizer_groups_by_encoder_prefix():
    model = _module(_tree(0))
    opt = toptim.make_depth_optimizer(model, 1e-3, 2e-3, 10, 0.1, 25.0)
    groups = opt.optimizer.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert [sorted(names[id(p)] for p in g["params"]) for g in groups] == [
        ["pretrained.mask_token", "pretrained.w"],
        ["depth_head.b", "depth_head.w"]]
    for g in groups:
        assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
        assert g["weight_decay"] == 0.01


# ------------------------------------------------------------- augment


def _jax_draws(key, batch, hw, cfg=jaug.AugmentConfig()):
    """The draws ``augment_batch`` makes from ``key``, as the port's
    ``AugmentParams`` (the JAX package's key splits, written out)."""
    h, w = hw
    flips, factors, orders, trans, scales = [], [], [], [], []
    for k in jax.random.split(key, batch):
        k_flip, k_jit, k_aff = jax.random.split(k, 3)
        flips.append(bool(jax.random.uniform(k_flip, ()) < cfg.hflip_prob))
        k_order, k_b, k_c, k_s, k_h = jax.random.split(k_jit, 5)
        factors.append([
            float(jax.random.uniform(k_b, (), minval=1 - cfg.brightness,
                                     maxval=1 + cfg.brightness)),
            float(jax.random.uniform(k_c, (), minval=1 - cfg.contrast,
                                     maxval=1 + cfg.contrast)),
            float(jax.random.uniform(k_s, (), minval=1 - cfg.saturation,
                                     maxval=1 + cfg.saturation)),
            float(jax.random.uniform(k_h, (), minval=-cfg.hue,
                                     maxval=cfg.hue))])
        orders.append(np.asarray(jax.random.permutation(k_order, 4)))
        k_tx, k_ty, k_sc = jax.random.split(k_aff, 3)
        max_dx, max_dy = cfg.translate[0] * w, cfg.translate[1] * h
        trans.append([
            float(jnp.round(jax.random.uniform(k_tx, (), minval=-max_dx,
                                               maxval=max_dx))),
            float(jnp.round(jax.random.uniform(k_ty, (), minval=-max_dy,
                                               maxval=max_dy)))])
        scales.append(float(jax.random.uniform(
            k_sc, (), minval=cfg.scale_range[0], maxval=cfg.scale_range[1])))
    return taug.AugmentParams(
        torch.tensor(flips), torch.tensor(factors, dtype=torch.float32),
        torch.from_numpy(np.stack(orders)).long(),
        torch.tensor(trans, dtype=torch.float32),
        torch.tensor(scales, dtype=torch.float32))


def _images(seed, shape=(3, 20, 26, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("op,factor", [("brightness", 1.17),
                                       ("contrast", 0.83),
                                       ("saturation", 1.09),
                                       ("hue", -0.13), ("hue", 0.19)])
def test_color_ops_match_jax(op, factor):
    img = _images(3)[0]
    got = getattr(taug, f"adjust_{op}")(torch.from_numpy(img), factor)
    want = getattr(jaug, f"adjust_{op}")(jnp.asarray(img), factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_color_jitter_and_affine_match_jax_with_its_draws():
    img = _images(4)[0]
    key = jax.random.PRNGKey(7)
    params = _jax_draws(key, 1, img.shape[:2])
    # The JAX per-image path below mirrors _augment_one's own key split.
    k_flip, k_jit, k_aff = jax.random.split(jax.random.split(key, 1)[0], 3)
    cfg = jaug.AugmentConfig()
    want = jaug.color_jitter(k_jit, jnp.asarray(img), cfg.brightness,
                             cfg.contrast, cfg.saturation, cfg.hue)
    got = taug.color_jitter(torch.from_numpy(img), params.factors[0].tolist(),
                            params.order[0].tolist())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jaug.random_affine(k_aff, jnp.asarray(img), cfg.translate,
                              cfg.scale_range)
    got = taug.random_affine(torch.from_numpy(img),
                             params.translate[0].tolist(),
                             params.scale[0].item())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_batch_matches_jax_with_its_draws():
    imgs = _images(5, (4, 20, 26, 3))
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(imgs),
                                         jaug.AugmentConfig()))
    params = _jax_draws(key, 4, imgs.shape[1:3])
    got = taug.apply_augment(torch.from_numpy(imgs), params)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(
        taug.preprocess_eval(torch.from_numpy(imgs)).numpy(),
        np.asarray(jaug.preprocess_eval(jnp.asarray(imgs))), atol=1e-6)


def test_draws_follow_the_config():
    gen = torch.Generator().manual_seed(0)
    cfg = taug.AugmentConfig()
    p = taug.draw_augment_params(gen, 64, (40, 50), cfg)
    assert p.flip.dtype == torch.bool and 0 < p.flip.sum() < 64
    lo = torch.tensor([0.8, 0.8, 0.9, -0.2])
    hi = torch.tensor([1.2, 1.2, 1.1, 0.2])
    assert ((p.factors >= lo) & (p.factors <= hi)).all()
    assert (p.order.sort(1).values == torch.arange(4)).all()
    assert (p.translate[:, 0].abs() <= 5).all()
    assert (p.translate[:, 1].abs() <= 4).all()
    assert torch.equal(p.translate, p.translate.round())
    assert ((p.scale >= 0.1) & (p.scale <= 0.9)).all()
    again = taug.draw_augment_params(torch.Generator().manual_seed(0), 64,
                                     (40, 50), cfg)
    assert all(torch.equal(a, b) for a, b in zip(p, again))


def _coordinate_image(h, w):
    """An image whose pixel (y, x) holds (y, x, 1): what an affine makes of
    it names each output pixel's source, and 0 in the last channel a
    fill."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return torch.from_numpy(np.stack([yy, xx, np.ones_like(yy)],
                                     -1).astype(np.float32))


@pytest.mark.parametrize("hw,scale_range", [((40, 50), (0.1, 0.9)),
                                            ((1, 37), (0.1, 0.9)),
                                            ((75, 64), (0.1, 0.1)),
                                            ((518, 518), (0.1, 0.9))],
                         ids=["40x50", "1-row", "scale-0.1", "518"])
def test_kernel_tables_match_random_affine(hw, scale_range):
    """The batched kernels' host table against the per-image path, bit for
    bit: each output pixel's source row and (flip folded in) column, and
    which pixels the affine fills, as ``hflip`` then ``random_affine`` move
    a coordinate image; and the factors as the plain ops round them."""
    h, w = hw
    cfg = taug.AugmentConfig(scale_range=scale_range)
    gen = torch.Generator().manual_seed(sum(hw))
    params = taug.draw_augment_params(gen, 12, hw, cfg)
    params = params._replace(flip=torch.arange(12) % 3 == 0)
    table = taug.augment_tables(params, 12, h, w)
    n = 12 * taug._TABLE_HEADER
    assert table.dtype == np.int32 and table.shape == (n + 12 * (h + w),)
    head = table[:n].reshape(12, -1)
    rows = table[n:n + 12 * h].reshape(12, h)
    cols = table[n + 12 * h:].reshape(12, w)
    coords = _coordinate_image(h, w)
    for i in range(12):
        img = coords.flip(1) if params.flip[i] else coords
        moved = taug.random_affine(img, params.translate[i].tolist(),
                                   params.scale[i].item()).numpy()
        kept = (rows[i][:, None] >= 0) & (cols[i][None, :] >= 0)
        np.testing.assert_array_equal(moved[..., 2] == 1, kept)
        assert kept.any() and not (moved[~kept] != 0).any()
        np.testing.assert_array_equal(
            moved[..., 0][kept], np.broadcast_to(rows[i][:, None],
                                                 (h, w))[kept])
        np.testing.assert_array_equal(
            moved[..., 1][kept], np.broadcast_to(cols[i][None, :],
                                                 (h, w))[kept])
    np.testing.assert_array_equal(head[:, :4], params.order.numpy())
    f = params.factors.double()
    want = torch.stack([f[:, 0], f[:, 1], 1 - f[:, 1], f[:, 2], 1 - f[:, 2],
                        f[:, 3]], 1).float().numpy()
    np.testing.assert_array_equal(head[:, 4:10].view(np.float32), want)
    assert not head[:, 10:].any()


def test_kernel_tables_refuse_draws_they_cannot_hold():
    """An order that is no permutation of the four ops, and draws for
    another number of images than the batch's, are refused before any
    launch."""
    params = taug.draw_augment_params(torch.Generator().manual_seed(1), 2,
                                      (8, 8))
    bad = params._replace(order=torch.tensor([[0, 1, 2, 3], [0, 0, 2, 3]]))
    with pytest.raises(ValueError, match="permutation"):
        taug.augment_tables(bad, 2, 8, 8)
    with pytest.raises(ValueError, match="3 images"):
        taug.augment_tables(params, 3, 8, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_images_take_the_plain_path_and_count_their_rows(dtype):
    """The dispatch rule: images on a CUDA device take the kernels; CPU
    images, whatever their dtype, go through the plain version, counted
    on ``augment.plain_rows`` and not on ``augment.kernel_rows``, and the
    kernels' entry point refuses them."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import debug

    imgs = torch.from_numpy(_images(6, (5, 20, 26, 3))).to(dtype)
    params = taug.draw_augment_params(torch.Generator().manual_seed(2), 5,
                                      (20, 26))
    assert not taug.takes_kernel(imgs)
    t0 = perf_counter_ns()
    launches = taug.augment_kernel.launches
    got = taug.apply_augment(imgs, params)
    assert torch.equal(got, taug.apply_augment_reference(imgs, params))
    assert taug.augment_kernel.launches == launches

    def rows(name):
        return sum(c.n for c in debug.counts(name, t0))

    assert rows("augment.plain_rows") == 5
    assert rows("augment.kernel_rows") == 0
    with pytest.raises(ValueError, match="CUDA"):
        taug.augment_kernel(imgs, params)


# ---------------------------------------------------------- preprocessor


def _raw_batch(seed, b=3, hw=(60, 64), combined=False):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
             "depth": rng.integers(0, 65536, (b, *hw), dtype=np.uint16)}
    if combined:
        batch["source"] = np.asarray([0, 1, 1][:b], np.int32)
    return batch


@pytest.mark.parametrize("combined", [False, True])
def test_preprocessor_eval_matches_jax(combined):
    batch = _raw_batch(0, combined=combined)
    maxd = (20.0, 10.0) if combined else None
    with jax.default_matmul_precision("highest"):
        want = jpre.DevicePreprocessor(size=56)(batch, train=False,
                                                max_depths=maxd)
    got = DevicePreprocessor(size=56, device="cpu")(batch, train=False,
                                                   max_depths=maxd)
    assert set(got) == set(want)
    assert got["image"].shape == (3, 56, 56, 3)
    assert got["depth"].shape == (3, 56, 56, 1)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=2e-5)
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), atol=2e-6)
    if combined:
        np.testing.assert_array_equal(got["max_depth"].numpy(),
                                      np.asarray(want["max_depth"]))


def test_preprocessor_train_matches_jax_with_its_draws():
    """The train path with the draws of the JAX key: the image is
    augmented, the depth only resized (flip and affine never touch it, as
    in the JAX package)."""
    batch = _raw_batch(1)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        want = jpre.DevicePreprocessor(size=56)(batch, train=True, rng=key)
        eval_depth = jpre.DevicePreprocessor(size=56)(batch,
                                                      train=False)["depth"]
    params = _jax_draws(key, 3, (56, 56))
    got = DevicePreprocessor(size=56, device="cpu")(batch, train=True,
                                                   aug_params=params)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=2e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(eval_depth),
                               atol=2e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = DevicePreprocessor(size=56, device="cpu")(batch, train=True,
                                                     generator=gen)
    assert torch.isfinite(drawn["image"]).all()
    with pytest.raises(ValueError, match="generator"):
        DevicePreprocessor(size=56, device="cpu")(batch, train=True)
