"""nvcc build-and-load helper for the port's CUDA sources.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` at
the root of the checkout (a directory git ignores), keyed by a hash of the
sources and flags, and loaded with ``ctypes``. PyTorch's headers are never
included, so a build takes seconds, not minutes. ``build`` starts one
``nvcc`` per missing library, all at once, so a cold start costs the
slowest source rather than their sum. The build happens at first use,
never at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every named source whose library is missing, in parallel.

    Returns the wall seconds of each compile (0.0 where the library was
    already built). Raises with nvcc's output if any compile fails. The
    compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        # A per-process temporary name: concurrent first builds must not
        # write one file; os.replace publishes whichever finishes first.
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu"),
               "-o", str(tmp)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, tmp, time.perf_counter())
    failures = []
    for name, (proc, so, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            if tmp.exists():
                tmp.unlink()
            continue
        so.with_name(so.name + ".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use) for ``name``."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (cached)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
