"""Run one cell of the benchmark and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for.  The run makes its inputs and weights from the seed, sets up and
warms up, measures for ``--seconds``, then checks what the measured
window produced against the plain reference in ``bench/reference/``.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones.  The numbers compared and their limits are the last
lines of standard error and the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness
    bm = harness.load_benchmark()
    cell = harness.workload(bm, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 4

    res = harness.run_cell(bm, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device="cuda:0", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 5
    print(json.dumps({"log": res["log"], "readings": res["readings"]}),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(res["correct"], res["attempted"],
                              res["failed"], res["metrics"], res["device"],
                              res["breakdown"], res["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
