"""Dry run of every (arch x shape) launch cell on the production meshes
(``repro/launch/dryrun.py``): each step runs on meta tensors, nothing is
allocated, and the roofline terms go to one JSON record per cell.

Per cell:
  1. The FULL variant on the single-pod 16 x 16 mesh, run on meta and
     counted (``analysis.measure``): the proof that the step runs at full
     shape, its flops, bytes and per-device memory.  Eager code runs every
     layer, so the count is direct: no scan is counted once.
  2. The multi-pod 2 x 16 x 16 mesh's layouts, for per-device memory
     (skipped with ``--skip-multipod``).
  3. The COST variants (1 and 2 layers per stack), counted and
     extrapolated to full depth (``analysis.extrapolate``), recorded beside
     the direct count.

The record keeps the reference's keys; the port's divergences (the ideal
split, no collectives: ``coll_wire_bytes`` and ``collective_s`` are null)
are listed in ``launch/analysis.py``.  ``--device cuda`` (the default)
reads the card (``torch.cuda.get_device_properties(0)`` and
``nvidia-smi``'s name and power limit) into the record's ``"hardware"``
and raises unless it is the H100 SXM5 80GB whose peaks
``analysis.h100_sxm()`` holds; ``--device cpu`` uses the same data-sheet
model without reading a card, and the record says so.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--jobs 4]   # every cell
  python -m repro_torch.launch.dryrun --report [--md]    # records -> table
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
import traceback


def _smi_name_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hardware(device: str):
    """``(HardwareModel, record)`` for ``device``: ``"cuda"`` reads the
    card and raises unless it is an H100 SXM5 80GB; ``"cpu"`` takes the
    data-sheet model without a card."""
    import torch

    from repro_torch.launch import analysis
    hw = analysis.h100_sxm()
    if device == "cpu":
        return hw, {"model": hw.name, "device": "cpu",
                    "source": "data sheet; no card read (--device cpu)"}
    if device != "cuda":
        raise ValueError(f"--device is cuda or cpu, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(--device cpu dry-runs with the data-sheet "
                           "model and reads no card)")
    props = torch.cuda.get_device_properties(0)
    smi = _smi_name_power()
    if "H100" not in props.name or "HBM3" not in props.name \
            or not 79e9 <= props.total_memory <= 90e9:
        raise RuntimeError(
            f"--device cuda: the card is {props.name!r} "
            f"({props.total_memory / 1e9:.1f} GB), not the H100 SXM5 80GB "
            "whose peaks analysis.h100_sxm() holds")
    return hw, {"model": hw.name, "device": "cuda", "source": "card",
                "torch_name": props.name,
                "total_memory": props.total_memory,
                "sm_count": props.multi_processor_count,
                "capability": [props.major, props.minor],
                "nvidia_smi": smi}


def _scaled_layers(arch: str) -> int:
    """Size of the homogeneous layer stack the cost variant extrapolates."""
    from repro_torch.configs import registry
    spec = registry.get(arch)
    cfg = spec.full_config()
    if spec.family in ("lm", "biencoder"):
        if getattr(cfg, "moe_num_experts", 0) > 0 and cfg.first_k_dense > 0:
            return cfg.n_layers - cfg.first_k_dense
        return cfg.n_layers
    if spec.family == "gnn":
        return cfg.n_layers
    return 1          # recsys: the cost variant keeps real depth


def _run_cell(arch: str, shape: str, *, skip_multipod: bool,
              device: str = "cuda", knobs=None, tag: str = "",
              hw=None) -> dict:
    """One cell's record; ``hw`` is :func:`hardware`'s pair (read here
    when None)."""
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    hw, hw_rec = hw or hardware(device)
    rec = {"arch": arch, "shape": shape, "ok": False, "tag": tag,
           "knobs": knobs or {}, "timings": {}, "split": "ideal",
           "hardware": hw_rec}

    def build(mesh, variant, cost_layers=1):
        kw = dict(knobs or {})
        builder_keys = {"sp", "serve_layout"}
        cfg_ov = {k: v for k, v in kw.items() if k not in builder_keys}
        kw = {k: v for k, v in kw.items() if k in builder_keys}
        if cfg_ov:
            kw["cfg_overrides"] = cfg_ov
        return build_step(arch, shape, mesh, variant=variant,
                          cost_layers=cost_layers, **kw)

    def counted(mesh, variant, cost_layers=1):
        t0 = time.time()
        spec = build(mesh, variant, cost_layers)
        m = analysis.measure(spec, mesh.size, hw)
        return spec, m, time.time() - t0

    single = make_production_mesh(multi_pod=False)
    world = single.size

    # -- 1. FULL variant on meta (single pod): runs, counted directly -----
    spec, full, dt = counted(single, "full")
    rec["timings"]["full_single_s"] = dt
    rec["meta"] = dict(spec.meta)
    rec["act_rules"] = getattr(spec.fn, "act_rules", None)
    rec["memory"] = dict(full.memory)
    rec["full_raw"] = {"flops": full.flops, "bytes": full.bytes_accessed,
                       "coll_wire_bytes": full.coll_wire_bytes}

    # -- 2. multi-pod layouts: per-device memory ----------------------------
    if not skip_multipod:
        _, mp, dt = counted(make_production_mesh(multi_pod=True), "full")
        rec["timings"]["full_multipod_s"] = dt
        rec["memory_multipod_per_device"] = mp.memory["per_device_total"]

    # -- 3. cost variants, extrapolated beside the direct count -------------
    n_scaled = _scaled_layers(arch)
    _, q1, dt1 = counted(single, "cost", 1)
    rec["timings"]["cost1_s"] = dt1
    q2 = None
    if n_scaled > 1:
        _, q2, dt2 = counted(single, "cost", 2)
        rec["timings"]["cost2_s"] = dt2
    ext = analysis.extrapolate(q1, q2, n_scaled)
    rec["per_device"] = {"flops": full.flops, "bytes": full.bytes_accessed,
                         "hbm_bytes_est": full.hbm_bytes_est,
                         "coll_wire_bytes": full.coll_wire_bytes,
                         "n_scaled_layers": n_scaled}
    rec["per_device_extrapolated"] = {
        "flops": ext.flops, "bytes": ext.bytes_accessed,
        "hbm_bytes_est": ext.hbm_bytes_est,
        "coll_wire_bytes": ext.coll_wire_bytes}
    rec["roofline"] = analysis.roofline(full, spec.meta["model_flops"]
                                        / world, hw)
    rec["collectives_1layer"] = {}
    rec["ok"] = True
    return rec


def _fmt_ms(s) -> str:
    return "-" if s is None else f"{s * 1e3:.2f}"


def _parse_knobs(text: str) -> dict:
    knobs = {}
    for kv in (text.split(",") if text else []):
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        knobs[k] = v
    return knobs


def run_one(args) -> int:
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    tag = args.tag or "baseline"
    path = os.path.join(out_dir, f"{args.arch}__{args.shape}__{tag}.json")
    knobs = _parse_knobs(args.knobs)
    hw = hardware(args.device)      # no card, or another card: raise here
    try:
        rec = _run_cell(args.arch, args.shape,
                        skip_multipod=args.skip_multipod, tag=tag,
                        device=args.device, knobs=knobs or None, hw=hw)
    except Exception as e:          # the record reports the failure
        rec = {"arch": args.arch, "shape": args.shape, "ok": False,
               "tag": tag, "error": repr(e),
               "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["ok"]:
        r = rec["roofline"]
        print(f"[dryrun] {args.arch}/{args.shape}: OK  "
              f"mem/dev={rec['memory']['per_device_total'] / 2**30:.2f}GiB  "
              f"compute={_fmt_ms(r['compute_s'])}ms "
              f"mem={_fmt_ms(r['memory_s'])}ms "
              f"coll={_fmt_ms(r['collective_s'])}ms -> {r['bottleneck']}  "
              f"roofline_frac={r['roofline_frac']:.3f}", flush=True)
        return 0
    print(f"[dryrun] {args.arch}/{args.shape}: FAIL {rec['error']}")
    print(rec.get("traceback", ""))
    return 1


def _child_env() -> dict:
    """This process's environment with the port's package on the path."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env


def run_all(args) -> int:
    """Run every cell in its own process (``--jobs`` at a time)."""
    from repro_torch.launch.steps import all_cells
    if args.device == "cuda":
        hardware("cuda")
    cells = all_cells(include_paper_arch=not args.assigned_only)
    if args.filter:
        cells = [c for c in cells if args.filter in f"{c[0]}/{c[1]}"]
    tag = args.tag or "baseline"
    if args.skip_existing:
        def done(a, s):
            p = os.path.join(args.out, f"{a}__{s}__{tag}.json")
            if not os.path.exists(p):
                return False
            with open(p) as f:
                return json.load(f).get("ok", False)

        cells = [c for c in cells if not done(*c)]
        print(f"[dryrun --all] {len(cells)} cells remaining")
    env = _child_env()
    procs, pending, failures, results = [], list(cells), [], []
    try:
        while pending or procs:
            while pending and len(procs) < args.jobs:
                arch, shape = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out,
                       "--device", args.device] \
                    + (["--skip-multipod"] if args.skip_multipod else []) \
                    + (["--tag", args.tag] if args.tag else []) \
                    + (["--knobs", args.knobs] if args.knobs else [])
                p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=env)
                procs.append((arch, shape, p))
            for item in list(procs):
                arch, shape, p = item
                if p.poll() is not None:
                    procs.remove(item)
                    print(p.stdout.read().strip(), flush=True)
                    p.stdout.close()
                    results.append((arch, shape, p.returncode))
                    if p.returncode != 0:
                        failures.append((arch, shape))
            time.sleep(0.2)
    finally:
        for _, _, p in procs:       # interrupted: stop what still runs
            p.kill()
            p.wait()
    print(f"\n[dryrun --all] {len(results) - len(failures)}/{len(results)}"
          " OK")
    for a, s in failures:
        print(f"  FAILED: {a}/{s}")
    return 1 if failures else 0


def report(args) -> int:
    rows = []
    for path in sorted(glob.glob(os.path.join(args.out, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            rows.append((rec["arch"], rec["shape"], rec.get("tag", ""),
                         "FAIL", "", "", "", "", "", "", "", ""))
            continue
        r = rec["roofline"]
        mp = rec.get("memory_multipod_per_device")
        rows.append((rec["arch"], rec["shape"], rec.get("tag", ""),
                     r["bottleneck"],
                     _fmt_ms(r["compute_s"]),
                     _fmt_ms(r["memory_s"]),
                     _fmt_ms(r.get("memory_raw_s", 0)),
                     _fmt_ms(r["collective_s"]),
                     f"{rec['memory']['per_device_total'] / 2**30:.2f}",
                     f"{mp / 2**30:.2f}" if mp else "-",
                     f"{r['useful_flops_frac']:.2f}",
                     f"{r['roofline_frac']:.3f}"))
    hdr = ("arch", "shape", "tag", "bound", "comp_ms", "mem_ms", "memraw_ms",
           "coll_ms", "GiB/dev", "GiB/dev@512", "useful", "roofline")
    if getattr(args, "md", False):
        print("| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
        for r in rows:
            print("| " + " | ".join(str(x) for x in r) + " |")
    else:
        widths = [max(len(str(r[i])) for r in rows + [hdr])
                  for i in range(len(hdr))]
        for r in [hdr] + rows:
            print("  ".join(str(x).ljust(w) for x, w in zip(r, widths)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--assigned-only", action="store_true")
    ap.add_argument("--filter", default="")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-multipod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--knobs", default="",
                    help="k=v[,k=v...] builder/config overrides "
                         "(sp=1, serve_layout=tp, param_dtype=bf16, ...)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: read the card's identity into each record "
                         "(raises without an H100 SXM5 80GB); cpu: the "
                         "data-sheet model, no card read")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.report:
        return report(args)
    if args.all:
        return run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --report)")
    return run_one(args)


if __name__ == "__main__":
    sys.exit(main())
