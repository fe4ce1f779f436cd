"""What a run imports: no JAX, no JAX package; the reference nothing of
the port either; and no result without a card."""

import json
import shutil
import subprocess
import sys

from h100_bench.tests.helpers import ROOT

CHECK = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted(sys.modules)))
"""
JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "orbax", "e3d_tpu",
             "enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
             "depth_and_pose_estimation_tpu"}
PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")


def _modules(imports: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(root=str(ROOT), imports=imports)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return {m.split(".", 1)[0] for m in json.loads(out.stdout)}


def test_the_run_loads_no_jax():
    tops = _modules(
        "import runpy; runpy.run_path('h100_bench/run.py', "
        "run_name='not_main')\n"
        "from h100_bench import harness, loadgen, trace, counts\n"
        "from h100_bench import serving, training\n"
        "from h100_bench.generators import closed_loop, open_loop, "
        "train_steps\n"
        "from h100_bench.reference import dav2\n"
        "import importlib\n"
        "for m in ('models.depth_anything', 'models.convert', "
        "'serving.engine'):\n"
        f"    importlib.import_module('{PORT}.' + m)")
    assert not tops & JAX_NAMES
    assert PORT in tops


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules("from h100_bench.reference import dav2\n"
                    "from h100_bench import weights, counts")
    assert not tops & JAX_NAMES
    assert PORT not in tops


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "vitl-serve-backlog", "--seed", "3000000001", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_beside_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "vitl-serve-backlog", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
