"""Weights across the two packages: ``from_jax_params`` inverts the JAX
package's ``convert_dav2`` exactly, and the port's modules carry the DAv2
checkpoint names, so a strict ``load_state_dict`` takes the result."""

import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.models import convert as jconvert
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import convert as tconvert
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model

DROPPED = "depth_head.scratch.refinenet4.resConfUnit1."


@pytest.mark.parametrize("encoder", ["vitt", "vits"])
def test_from_jax_params_inverts_convert_dav2(encoder):
    sd = jconvert.synthetic_dav2_state_dict(encoder, seed=3)
    back = tconvert.from_jax_params(jconvert.convert_dav2(sd, encoder))
    expected = {k: v for k, v in sd.items() if not k.startswith(DROPPED)}
    assert any(k.startswith(DROPPED) for k in sd)
    assert sorted(back) == sorted(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)

    model = build_depth_model(encoder, device="cpu")
    model.load_state_dict(back, strict=True)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), expected[key])


@pytest.mark.parametrize("encoder", ["vitt", "vits"])
def test_checkpoint_state_dict_loads(encoder):
    """A reference checkpoint (every DAv2 key, refinenet4's unused unit
    included) loads strictly after the documented drop."""
    sd = tconvert.synthetic_dav2_state_dict(encoder, seed=1)
    reference = jconvert.synthetic_dav2_state_dict(encoder, seed=1)
    assert sorted(sd) == sorted(reference)
    for key in sd:
        np.testing.assert_array_equal(sd[key], reference[key])
    model = build_depth_model(encoder, device="cpu")
    with pytest.raises(RuntimeError, match="resConfUnit1"):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                              strict=True)
    tconvert.load_dav2_state_dict(model, sd)
    got = model.state_dict()["pretrained.blocks.0.attn.qkv.weight"]
    np.testing.assert_array_equal(got.numpy(),
                                  sd["pretrained.blocks.0.attn.qkv.weight"])


def test_load_torch_state_dict_strips_lightning_prefix(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": {"model.pretrained.norm.weight": w,
                               "depth_head.projects.0.bias": w[0]}}, path)
    state = tconvert.load_torch_state_dict(str(path))
    assert sorted(state) == ["depth_head.projects.0.bias",
                             "pretrained.norm.weight"]
    torch.testing.assert_close(state["pretrained.norm.weight"], w)
