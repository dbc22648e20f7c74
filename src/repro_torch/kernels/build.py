"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
sources under ``src/repro_torch/csrc/`` into ``build/repro_torch/<hash>/``
at the root of the checkout (a git-ignored directory).  The hash covers the
sources and the compiler flags, so an edited source builds anew and an
unchanged one is reused.  The library has a plain C interface and is loaded
with :mod:`ctypes`; nothing here includes PyTorch's headers, which keeps a
build to seconds.

Nothing is compiled when this module is imported: :func:`load_library` is
called by a kernel wrapper the first time it launches on a CUDA tensor.
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


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into ``lib<name>.so``
    unless a build of the same sources and flags exists, then load it.

    Raises ``RuntimeError`` with nvcc's output when nvcc is missing or the
    build fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        paths = [os.path.join(CSRC, s) for s in sources]
        h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        for p in paths:
            with open(p, "rb") as f:
                h.update(f.read())
        out_dir = os.path.abspath(os.path.join(BUILD_ROOT,
                                               h.hexdigest()[:16]))
        so = os.path.join(out_dir, f"lib{name}.so")
        log_path = os.path.join(out_dir, f"lib{name}.log")
        seconds = 0.0
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, *paths]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building lib{name}.so:"
                    f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            with open(log_path, "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, so)            # atomic: a reader never sees half
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": so}
        lib = _LIBS[name] = ctypes.CDLL(so)
        return lib
