"""What the entry point needs besides the work itself: finding a cell's
files by name, the device record, the result line, and the check that
the process loaded nothing of JAX.

Everything a cell is made of is found by the names in ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: the configuration as it is run;
* ``bench/models/<model_type>.py``: the trunk of the configuration's
  ``model_type``: its checkpoint layout, reference, FLOP count and the
  sizes the port is checked against (:mod:`bench.models`);
* ``bench/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver in ``bench/kinds/`` that runs it;
* ``bench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric, with a
  ``read(ctx)`` that returns the metric's value or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

from bench import models

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

#: top-level module names that may not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def workload(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"(workloads: {[w['name'] for w in bm['workloads']]})")


def config(name: str) -> dict:
    return load_json(BENCH, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH, "traffic", f"{name}.json")


def limits(cell: str) -> Dict[str, float]:
    return load_json(BENCH, "limits", f"{cell}.json")["limits"]


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bm: dict, cell: str) -> List[dict]:
    return [m for m in bm["end_to_end"] if _for_cell(m, cell)]


def per_layer(bm: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bm, cell)}
    return [m for m in bm["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(device, chips: int, memory_peak: int) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(memory_peak),
                "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(memory_peak)}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: dict) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks              # the numbers compared come last
    return json.dumps(out)


def run_cell(bm: dict, cell: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, cfg=None,
             mix=None) -> dict:
    """Run one cell and reduce it to its result (the fields of the last
    line, and ``readings`` for the log).  ``cfg`` / ``mix`` replace the
    cell's files (the benchmark's CPU tests run a cell at a small size)."""
    w = workload(bm, cell)
    cfg = cfg if cfg is not None else config(w["config"])
    mix = mix if mix is not None else traffic(w["traffic"])
    models.of(cfg)                  # a trunk without a module stops here
    out = driver(mix["kind"]).run(
        cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
        device=device, t_start=t_start, limits=limits(cell))
    if trace:
        metrics = {}
        for m in per_layer(bm, cell):
            v = reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["measured"][m["name"]]),
                               "unit": m["unit"]}
                   for m in end_to_end(bm, cell)}
    dev = device_record(device, w["chips"], out["memory_peak"])
    if trace:
        dev["busy_s"] = out["ctx"]["trace"]["busy_s"]
        dev["window_s"] = out["ctx"]["trace"]["window_s"]
    return {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev,
            "breakdown": {"device_ops": out["ctx"]["trace"]["device_ops"],
                          "idle_gaps": out["ctx"]["trace"]["idle_gaps"]}
            if trace else None,
            "checks": out["checks"], "readings": out["readings"],
            "log": out.get("log", {})}
