"""The port imports neither JAX nor any module of the JAX package."""

import os
import subprocess
import sys

PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")
JAX_PACKAGE = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
               "depth_and_pose_estimation_tpu")

_PROBE = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None    # any "import jax" now raises ImportError
sys.modules["flax"] = None
import {PORT} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, "{PORT}.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n in ("{JAX_PACKAGE}", "e3d_tpu")
                or n.startswith(("{JAX_PACKAGE}.", "e3d_tpu.")))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 12, names
"""


def test_port_imports_without_jax_or_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
