"""The port's ToMe token merging (``ops/token_merge.py``) against the JAX
package's on the CPU, on tokens made from a seed with numpy: equal merge
counts and slot maps, merged tokens within 1e-6 (both average in f32; the
partners' sums may add in another order), and the unmerged sequence. The
whole model with merging is held against the JAX package in
``tests/test_torch_quant.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import token_merge as jtm
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import token_merge as ttm


def test_merge_count_matches_jax():
    for n in (0, 1, 2, 3, 16, 17, 1369, 1370):
        for ratio in (0.0, 0.1, 0.25, 0.3, 0.5, 0.9, 1.0):
            assert ttm.merge_count(n, ratio) == jtm.merge_count(n, ratio)
    assert ttm.merge_count(1369, 0.3) == 410  # vitl at 518 px: 1370 -> 960


@pytest.mark.parametrize("n,ratio", [(16, 0.25), (25, 0.3), (35, 0.6)])
def test_bipartite_merge_and_unmerge_match_jax(n, ratio):
    x = np.random.default_rng(n).normal(size=(2, 1 + n, 24)).astype(
        np.float32)
    x[1, 5] = x[1, 6]  # an exact duplicate pair: a tie-free best score of 1
    jm, jslot = jtm.bipartite_merge(jnp.asarray(x), ratio)
    tm, tslot = ttm.bipartite_merge(torch.from_numpy(x), ratio)
    r = ttm.merge_count(n, ratio)
    assert tm.shape == jm.shape == (2, 1 + n - r, 24)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ttm.unmerge(tm, tslot).numpy(),
                               np.asarray(jtm.unmerge(jm, jslot)),
                               atol=1e-6, rtol=0)
    # cls and every token that was not merged come back exactly
    full = ttm.unmerge(tm, tslot).numpy()
    exact = np.all(full == x, axis=-1)
    assert exact[:, 0].all() and (exact.sum(axis=1) >= 1 + n - 2 * r).all()


def test_ratio_zero_and_dtype():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 17, 8)).astype(np.float32))
    merged, slot = ttm.bipartite_merge(x, 0.0)
    assert merged is x and slot.tolist() == [list(range(17))]
    merged, slot = ttm.bipartite_merge(x.bfloat16(), 0.25)
    assert merged.dtype == torch.bfloat16 and merged.shape == (1, 13, 8)
    assert ttm.unmerge(merged, slot).shape == (1, 17, 8)
