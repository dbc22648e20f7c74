"""The port stands alone: nothing under src/repro_torch/, not chip_smoke.py
and not the examples' torch twins (examples/*_torch.py) imports jax,
ml_dtypes or the JAX package ``repro``; the twins import no ``benchmarks``
module either (those import jax).

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
EXAMPLES = os.path.join(ROOT, "examples")
# "repro" followed by anything but "_" (so repro_torch is not a match)
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ml_dtypes|repro)(?![\w])")


BENCHMARKS = re.compile(r"^\s*(?:import|from)\s+benchmarks(?![\w])")


def _twins():
    return sorted(os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
                  if f.endswith("_torch.py"))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + _twins()
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        if path.endswith("chip_smoke.py") or path in _twins():
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
        bad = [line.rstrip() for line in f if FORBIDDEN.match(line)
               or (path in _twins() and BENCHMARKS.match(line))]
    assert not bad, bad


def test_every_example_has_a_twin():
    originals = sorted(f[:-3] for f in os.listdir(EXAMPLES)
                       if f.endswith(".py") and not f.endswith("_torch.py"))
    assert len(originals) == 11
    assert [os.path.basename(p)[:-9] for p in _twins()] == originals


def test_every_module_imports_without_jax_or_repro():
    script = (
        "import importlib, importlib.util, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',"
        " 'repro', 'benchmarks'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {os.path.abspath(ROOT)!r})\n"
        "importlib.import_module('chip_smoke')\n"
        f"for path in {_twins()!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_splitter_main_runs_without_jax_or_repro(tmp_path):
    """``python -m repro_torch.core.splitter`` end to end (its imports
    inside ``main`` included) with jax, ml_dtypes and repro blocked."""
    (tmp_path / "corpus").mkdir()
    with open(tmp_path / "corpus" / "c.jsonl", "w") as f:
        for i in range(6):
            f.write(f'{{"text_id": "d{i}", "text": [1, {i + 2}]}}\n')
    with open(tmp_path / "run.trec", "w") as f:
        f.write("q0 Q0 d3 1 2.0 bm25\nq0 Q0 d1 2 1.0 bm25\n")
    with open(tmp_path / "qrels.txt", "w") as f:
        f.write("q0 0 d5 1\n")
    script = (
        "import runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',"
        " 'repro'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['splitter', '--candidate_dir', sys.argv[1] + '/corpus',"
        " '--run_file', sys.argv[1] + '/run.trec', '--qrel_file',"
        " sys.argv[1] + '/qrels.txt', '--output_dir', sys.argv[1] + '/out',"
        " '--depth', '1']\n"
        "runpy.run_module('repro_torch.core.splitter', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "out" / "subset_top1.jsonl") as f:
        assert [line.split('"')[3] for line in f] == ["d3", "d5"]


def test_launch_train_runs_without_jax_or_repro(tmp_path):
    """``python -m repro_torch.launch.train`` (trainer, async saver,
    validator thread, telemetry-free) end to end on the CPU with jax,
    ml_dtypes and repro blocked; the trainer's modules and ``obs`` are in
    the static scan above."""
    script = (
        "import runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',"
        " 'repro'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.obs, repro_torch.obs.export\n"
        "sys.argv = ['train', '--device', 'cpu', '--workdir', sys.argv[1],"
        " '--steps', '6', '--ckpt-every', '3', '--corpus-size', '60',"
        " '--n-queries', '6']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary["validated_steps"] == [3, 6] and not summary["errors"]
    assert any(p.endswith(os.path.join("repro_torch", "train", "trainer.py"))
               for p in _sources())
