"""Build-and-load helper for the port's native sources.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` at
the root of the checkout (a directory git ignores), keyed by a hash of the
sources and flags, and loaded with ``ctypes``. PyTorch's headers are never
included, so a build takes seconds, not minutes.

Host C++ sources, ``csrc/host/<name>.cpp`` (the media and image codecs),
are named ``host/<name>`` and compiled by ``g++`` with the JAX package's
flags (``-O3 -march=native``, so the codecs' output matches it byte for
byte), and the libraries a source links (``HOST_LINK``: zlib for the PNG
reader), into ``build/host/<name>_<hash>_<isa>.so``; the hash covers the
source and every flag, and the ISA tag keeps a library tuned for one CPU
from being loaded on another.

``build`` starts one compiler per missing library, all at once, so a cold
start costs the slowest source rather than their sum. The build happens
at first use, never at import: the CPU tests import every module of the
port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
HOST_BUILD_DIR = BUILD_ROOT / "host"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
HOST_PREFIX = "host/"
# Libraries a host source links, after the source on g++'s command line.
HOST_LINK = {"host/pngdec": ("-lz",)}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ with the CUDA toolkit")
    return path


def _host_isa_tag() -> str:
    """Hash of the host ISA, so a -march=native library is never reused on
    a CPU it was not built for (a copied checkout would SIGILL)."""
    flags = platform.machine()
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags += line
                    break
    except OSError:
        pass
    return hashlib.sha256(flags.encode()).hexdigest()[:8]


def _is_host(name: str) -> bool:
    return name.startswith(HOST_PREFIX)


def _source(name: str) -> Path:
    if _is_host(name):
        return CSRC_DIR / "host" / f"{name[len(HOST_PREFIX):]}.cpp"
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library built from ``name``'s source lives."""
    host = _is_host(name)
    flags = (*HOST_FLAGS, *HOST_LINK.get(name, ())) if host else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_source(name).read_bytes())
    if host:
        return (HOST_BUILD_DIR / f"{name[len(HOST_PREFIX):]}_"
                f"{h.hexdigest()[:16]}_{_host_isa_tag()}.so")
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    if _is_host(name):
        return ["g++", *HOST_FLAGS, str(_source(name)), "-o", str(out),
                *HOST_LINK.get(name, ())]
    return [_nvcc(), *NVCC_FLAGS, str(_source(name)), "-o", str(out)]


def build(names: list[str]) -> dict[str, float]:
    """Compile every named source whose library is missing, in parallel.

    Returns the wall seconds of each compile (0.0 where the library was
    already built). Raises with the compiler's output if any compile
    fails. The compiler's report (for ``nvcc``, ``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    procs = {}
    seconds = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        # A per-process temporary name: concurrent first builds must not
        # write one file; os.replace publishes whichever finishes first.
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, tmp, time.perf_counter())
    failures = []
    for name, (proc, so, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: exited {proc.returncode}\n{out}")
            if tmp.exists():
                tmp.unlink()
            continue
        so.with_name(so.name + ".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (for nvcc: register and
    shared-memory use)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``name`` (``csrc/<name>.cu``, or ``csrc/host/<file>.cpp`` for
    ``host/<file>``) if needed and load it (cached)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
