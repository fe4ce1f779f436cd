"""The port's vitg pieces on the CPU: the fused-SwiGLU FFN and a vitt
``DinoViT`` with ``ffn="swiglu"`` against the JAX package's, the DAv2
giant key layout, and the HuggingFace second oracles (tiny configs,
random weights, no download).

Tolerances: f32 on both sides (JAX matmuls at ``highest``): 1e-5 on one
SwiGLU of unit-scale inputs, 1e-4 on LayerNorm-ed taps through four blocks
(as ``test_torch_dinov2.py``); bf16 rounds every activation to 8 bits of
mantissa in places that differ between flax and torch: 0.05 on one SwiGLU
(outputs of about unit scale). Against HuggingFace: 2e-4 on the encoder's
last hidden state and 5e-4 m on metric depth, the bounds of the JAX
package's own HF tests (``tests/test_dinov2_parity.py``,
``tests/test_depth_anything_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.models.dinov2 import DinoViT as JaxDinoViT
from e3d_tpu.models.dinov2 import SwiGLU as JaxSwiGLU
from e3d_tpu.ops import attention as jattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import dinov2 as tdino
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import (
    from_jax_params, load_dav2_state_dict, load_or_init_depth_model,
    synthetic_dav2_state_dict)
from tests.test_depth_anything_parity import hf_head_to_dav2
from tests.test_dinov2_parity import hf_to_dav2_state


def _transformers():
    # TensorFlow is installed beside torch here; the oracles need only
    # transformers' torch models, so skip loading it (half the import).
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        return pytest.importorskip("transformers")


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.05)])
def test_swiglu_matches_jax(dtype, tol):
    dim = 64
    hidden = tdino.swiglu_hidden(dim)
    assert hidden == 176 and tdino.swiglu_hidden(1536) == 4096
    jmod = JaxSwiGLU(hidden, dim, getattr(jnp, dtype))
    x = np.random.default_rng(0).normal(size=(2, 9, dim)).astype(np.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), x)["params"]
    mlp = jax.tree_util.tree_map(np.asarray, params)
    sd = from_jax_params({"pretrained": {"blocks_0": {"mlp": mlp}}})
    tmod = tdino.SwiGLU(dim, hidden)
    tmod.load_state_dict(_strip(sd, "pretrained.blocks.0.mlp."), strict=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)(
            {"params": params}, jnp.asarray(x, getattr(jnp, dtype))),
            np.float32)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_int8_matches_jax(dtype):
    """``SwiGLU(quant=True)`` (W8A8, the int8 dial on vitg's FFN) against
    the JAX package's at dim 64 with the same weights: f32 within 1e-5;
    in bf16 the two frameworks round in different places before each
    quantization, so the int8 distance is held to twice the plain bf16
    FFN's distance between them."""
    dim = 64
    hidden = tdino.swiglu_hidden(dim)
    x = np.random.default_rng(0).normal(size=(2, 9, dim)).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax.jit(JaxSwiGLU(hidden, dim, jdtype).init)(
        jax.random.PRNGKey(1), x)["params"]
    mlp = jax.tree_util.tree_map(np.asarray, params)
    sd = from_jax_params({"pretrained": {"blocks_0": {"mlp": mlp}}})
    tmod = tdino.SwiGLU(dim, hidden)
    tmod.load_state_dict(_strip(sd, "pretrained.blocks.0.mlp."), strict=True)
    dist = {}
    for quant in (False, True):
        jmod = JaxSwiGLU(hidden, dim, jdtype, quant=quant)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jax.jit(jmod.apply)(
                {"params": params}, jnp.asarray(x, jdtype)), np.float32)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x).to(tdtype), quant=quant)
        assert got.dtype == tdtype
        dist[quant] = float(np.abs(got.float().numpy() - want).max())
    if dtype == "float32":
        assert dist[True] <= 1e-5, dist
    else:
        assert dist[True] <= 2 * dist[False], dist


@pytest.mark.parametrize("hw,fused", [((56, 56), False), ((56, 84), True)],
                         ids=["xla", "pallas"])
def test_swiglu_dinovit_taps_match_jax(hw, fused):
    """vitt with vitg's FFN: the JAX taps on its XLA attention and on the
    pad-once stream with the Pallas kernel (interpret mode); the port
    never pads."""
    jmodel = JaxDinoViT("vitt", dtype=jnp.float32, ffn="swiglu")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), np.zeros(
        (1, 56, 56, 3), np.float32))["params"]
    assert "w12" in params["blocks_0"]["mlp"]
    sd = from_jax_params({"pretrained": jax.tree_util.tree_map(np.asarray,
                                                               params)})
    tmodel = tdino.DinoViT("vitt", torch.float32, ffn="swiglu")
    tmodel.load_state_dict(_strip(sd, "pretrained."), strict=True)
    img = np.random.default_rng(2).normal(size=(2, *hw, 3)).astype(np.float32)
    jattn.set_force_fused(fused)
    try:
        with jax.default_matmul_precision("highest"):
            jtaps = jax.jit(jmodel.apply)({"params": params},
                                          jnp.asarray(img))
    finally:
        jattn.set_force_fused(False)
    with torch.no_grad():
        ttaps = tmodel(torch.from_numpy(img))
    for (jp, jc), (tp, tc) in zip(jtaps, ttaps):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)


def test_gradient_checkpointing_covers_the_swiglu_block():
    """Recomputed SwiGLU blocks give the gradients of stored ones."""
    img = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 56, 56, 3)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = tdino.DinoViT("vitt", torch.float32, remat, ffn="swiglu")
        tda.init_random(model, seed=4).train()
        loss = sum(p.square().mean() + c.sum() for p, c in model(img))
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert any(".mlp.w12." in n for n in grads[1])
    assert any(".mlp.w3." in n for n in grads[1])
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_vitg_has_the_giant_layout():
    """The full vitg on the meta device (no memory): 40 SwiGLU blocks of
    the DAv2 giant's shapes, no fc1/fc2, about 1.1 B encoder parameters."""
    with torch.device("meta"):
        model = tda.DepthAnythingV2("vitg", 384, (1536,) * 4)
    sd = model.state_dict()
    assert sd["pretrained.blocks.39.mlp.w12.weight"].shape == (8192, 1536)
    assert sd["pretrained.blocks.39.mlp.w3.weight"].shape == (1536, 4096)
    assert not any(".fc1." in k or ".fc2." in k for k in sd)
    enc = sum(v.numel() for k, v in sd.items() if k.startswith("pretrained."))
    assert 1.1e9 < enc < 1.2e9, enc


def test_synthetic_giant_state_dict_loads(monkeypatch, tmp_path):
    """``synthetic_dav2_state_dict("vitg")`` and ``load_or_init_depth_model``
    on vitg's key layout (the SwiGLU FFN) at a narrow width: a ``.pth``
    with the Lightning prefix loads strictly."""
    monkeypatch.setitem(tdino.VIT_ARCHS, "vitg",
                        dict(embed_dim=48, depth=4, num_heads=2,
                             ffn="swiglu"))
    monkeypatch.setitem(tdino.INTERMEDIATE_LAYER_IDX, "vitg", [0, 1, 2, 3])
    monkeypatch.setitem(tda.MODEL_CONFIGS, "vitg",
                        {"encoder": "vitg", "features": 16,
                         "out_channels": [48] * 4})
    sd = synthetic_dav2_state_dict("vitg", seed=5)
    assert sd["pretrained.blocks.3.mlp.w12.weight"].shape == (
        2 * tdino.swiglu_hidden(48), 48)
    path = tmp_path / "giant.pth"
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    model = load_or_init_depth_model("vitg", 20.0, str(path), device="cpu",
                                     dtype=torch.float32)
    got = model.state_dict()["pretrained.blocks.2.mlp.w3.weight"]
    np.testing.assert_array_equal(got.numpy(),
                                  sd["pretrained.blocks.2.mlp.w3.weight"])
    with torch.no_grad():
        depth = model(torch.zeros(1, 28, 28, 3))
    assert depth.shape == (1, 28, 28) and torch.isfinite(depth).all()


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_encoder_matches_transformers_dinov2(ffn):
    transformers = _transformers()
    cfg = transformers.Dinov2Config(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=256, patch_size=14, image_size=56,
        layerscale_value=1.0, hidden_act="gelu",
        use_swiglu_ffn=ffn == "swiglu")
    torch.manual_seed(6)
    hf = transformers.Dinov2Model(cfg).eval()
    state = hf_to_dav2_state(hf.state_dict(), depth=4)
    model = tdino.DinoViT("vitt", torch.float32, ffn=ffn)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _strip(state, "pretrained.").items()}, strict=True)
    x = np.random.default_rng(7).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))
                  ).last_hidden_state.numpy()
        patch, cls = model(torch.from_numpy(x), tap_indices=[3])[0]
    got = torch.cat([cls[:, None], patch], dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_full_model_matches_transformers_depth_anything(ffn):
    transformers = _transformers()
    bb = transformers.Dinov2Config(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=256, patch_size=14, image_size=56,
        layerscale_value=1.0, out_indices=[1, 2, 3, 4],
        apply_layernorm=True, reshape_hidden_states=False,
        use_swiglu_ffn=ffn == "swiglu")
    cfg = transformers.DepthAnythingConfig(
        backbone_config=bb, depth_estimation_type="metric", max_depth=20.0,
        fusion_hidden_size=32, reassemble_hidden_size=64,
        neck_hidden_sizes=[16, 32, 48, 64], head_hidden_size=32)
    torch.manual_seed(8)
    hf = transformers.DepthAnythingForDepthEstimation(cfg).eval()
    sd = hf.state_dict()
    state = hf_to_dav2_state(_strip(sd, "backbone."), depth=4)
    state.update(hf_head_to_dav2(sd))
    model = tda.DepthAnythingV2("vitt", 32, (16, 32, 48, 64), 20.0,
                                torch.float32)
    model.pretrained = tdino.DinoViT("vitt", torch.float32, ffn=ffn)
    load_dav2_state_dict(model, state).eval()
    x = np.random.default_rng(9).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2))
                  ).predicted_depth.numpy()
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 56, 56)
    np.testing.assert_allclose(got, want, atol=5e-4)
