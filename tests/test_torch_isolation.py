"""The port stands alone: nothing under src/repro_torch/ and not chip_smoke.py
imports jax, ml_dtypes or the JAX package ``repro``.

A static scan of every import line, and an import of every module in a
subprocess where those packages cannot be imported (as on the GPU machine,
which has no JAX).
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
# "repro" followed by anything but "_" (so repro_torch is not a match)
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ml_dtypes|repro)(?![\w])")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def test_pattern_tells_repro_from_repro_torch():
    assert FORBIDDEN.match("from repro.core import metrics")
    assert FORBIDDEN.match("import repro.ckpt")
    assert FORBIDDEN.match("from repro import core")
    assert FORBIDDEN.match("    import jax.numpy as jnp")
    assert not FORBIDDEN.match("from repro_torch.core import metrics")
    assert not FORBIDDEN.match("import repro_torch")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_lines(path):
    with open(path) as f:
        bad = [line.rstrip() for line in f if FORBIDDEN.match(line)]
    assert not bad, bad


def test_every_module_imports_without_jax_or_repro():
    script = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',"
        " 'repro'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {os.path.abspath(ROOT)!r})\n"
        "importlib.import_module('chip_smoke')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
