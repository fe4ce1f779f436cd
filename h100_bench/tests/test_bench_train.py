"""The training cell's check: the reference against the port's step, the
control, and runs with the step broken underneath.

The tiny model stands in for vitl at a size a CPU test holds, held to
vitl-finetune's limits. Its leaves hold few elements, so bf16 rounding
moves their gradient norms far more than vitl's (about 0.05 of the
median leaf against vitl's 0.01): the runs here compute in float32,
where a sound step's gap is rounding's alone, and the faults stand out."""

import pytest
import torch

from h100_bench import harness
from h100_bench.calibrate import FAULTS, planted, train_control_reading
from h100_bench.tests.helpers import tiny_train_spec

SEED = 2**32 + 11


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_reference_is_the_ports_step_in_f32():
    """In float32 on both sides only rounding parts them."""
    out = harness.run_cell(tiny_train_spec(dtype="float32"), SEED, 0.2,
                           False, "cpu")
    nums = out["_run"].extra["numbers"]
    assert nums["loss_rel_gap"] < 1e-5
    assert nums["grad_leaf_gap"] < 1e-3
    assert nums["grad_leaves"] > 100
    assert nums["grad_diff_gap"] < 1e-3
    assert nums["change_leaf_gap"] < 1e-2
    assert nums["change_leaves"] == nums["grad_leaves"]
    assert nums["hyper_gap"] < 1e-6


def test_control_fails_a_limit():
    spec = tiny_train_spec()
    nums = train_control_reading(spec, SEED, "cpu")
    for number in ("grad_leaf_gap", "grad_diff_gap"):
        assert nums[number] > spec["limits"][number]


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_run_with_the_step_broken_is_not_correct(fault):
    with planted(fault):
        out = harness.run_cell(tiny_train_spec(dtype="float32"), SEED, 0.2,
                               False, "cpu")
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,number", [
    ("lr_x10", "change_leaf_gap"), ("swapped", "change_leaf_gap"),
    ("lr_x10", "hyper_gap"), ("swapped", "hyper_gap"),
    ("ahead", "hyper_gap")])
def test_a_wrong_update_fails_the_number_that_sees_it(fault, number):
    """The optimizer's faults leave the first gradient as it was; the
    parameters' change and the groups' learning rates see them."""
    with planted(fault):
        out = harness.run_cell(tiny_train_spec(dtype="float32"), SEED, 0.2,
                               False, "cpu")
    checks = out["checks"]
    assert checks["grad_leaf_gap"]["value"] <= checks["grad_leaf_gap"][
        "limit"]
    assert checks[number]["value"] > checks[number]["limit"], checks
