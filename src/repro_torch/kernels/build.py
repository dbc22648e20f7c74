"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
sources under ``src/repro_torch/csrc/`` into ``build/repro_torch/<hash>/``
at the root of the checkout (a git-ignored directory).  The hash covers the
sources and the compiler flags, so an edited source builds anew and an
unchanged one is reused.  The library has a plain C interface and is loaded
with :mod:`ctypes`; nothing here includes PyTorch's headers, which keeps a
build to seconds.

Nothing is compiled when this module is imported: :func:`load_libraries`
is called by a kernel wrapper the first time it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "build", "repro_torch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": compile time (0.0 on a cache hit), "log": nvcc stderr}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are compiled at first use and need the CUDA "
                           "toolkit on PATH (or /usr/local/cuda/bin)")
    return path


def _target(name: str, sources: Sequence[str]):
    """(library path, log path, source paths) of a build of ``sources``."""
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.abspath(os.path.join(BUILD_ROOT, h.hexdigest()[:16]))
    return (os.path.join(out_dir, f"lib{name}.so"),
            os.path.join(out_dir, f"lib{name}.log"), paths)


def load_libraries(specs: Dict[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """Compile each library of ``specs`` (name -> file names under
    ``csrc/``) into ``lib<name>.so`` unless a build of the same sources and
    flags exists, then load them all.  The builds run as one nvcc process
    per library, all started together.

    Raises ``RuntimeError`` with nvcc's output when nvcc is missing or a
    build fails."""
    with _LOCK:
        todo = {name: _target(name, sources)
                for name, sources in specs.items() if name not in _LIBS}
        builds = {}
        for name, (so, _, paths) in todo.items():
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, *paths]
                builds[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, time.perf_counter())
        seconds, failed = {}, []
        for name, (proc, tmp, t0) in builds.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            so, log_path, _ = todo[name]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"lib{name}.so:\n{' '.join(proc.args)}\n{log}")
                continue
            with open(log_path, "w") as f:
                f.write(log)
            os.replace(tmp, so)            # atomic: a reader never sees half
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (so, log_path, _) in todo.items():
            log = ""
            if os.path.exists(log_path):
                with open(log_path) as f:
                    log = f.read()
            BUILD_INFO[name] = {"seconds": seconds.get(name, 0.0), "log": log,
                                "path": so}
            _LIBS[name] = ctypes.CDLL(so)
        return {name: _LIBS[name] for name in specs}
