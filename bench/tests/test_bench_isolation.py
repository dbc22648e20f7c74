"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import json
import os
import subprocess
import sys

from bench import harness

ROOT = harness.ROOT

_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
import bench.run, bench.control, bench.sweep
bm = harness.load_benchmark()
for w in bm["workloads"]:
    mix = harness.traffic(w["traffic"])
    harness.driver(mix["kind"])
    harness.config(w["config"])
    for m in harness.per_layer(bm, w["name"]):
        harness.reader(m["name"])
# what the drivers import from the port when they run
import repro_torch.ckpt.checkpoint, repro_torch.core.suite
import repro_torch.core.validator, repro_torch.obs
import repro_torch.serve.service, repro_torch.serve.index
import repro_torch.configs.registry, repro_torch.models.biencoder
print(json.dumps(sorted(sys.modules)))
"""

_REF = """
import json, sys
sys.path[:0] = [{root!r}]
import bench.reference.encoders, bench.reference.search
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(
        root=ROOT, src=os.path.join(ROOT, "src"))], capture_output=True,
        text=True, check=True, env=env, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules(_RUN)
    assert "repro_torch" in mods
    bad = [m for m in mods if m.split(".")[0] in harness.FORBIDDEN]
    assert bad == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(_REF)
    top = {m.split(".")[0] for m in mods}
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert not [m for m in mods
                if m == "bench.port" or m.startswith("bench.kinds")]
