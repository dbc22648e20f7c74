"""The control of a cell: the plain reference put in the program's place
at the precision below the configuration's (fp8 weight products for a
bf16 trunk), at the cell's own size, judged by the cell's comparison.
It has to come out as not correct on every seed.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>]

Prints one JSON line per seed: the readings, the limits, and whether the
control failed them.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness, judge
    bm = harness.load_benchmark()
    w = harness.workload(bm, args.workload)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    limits = harness.limits(args.workload)
    seconds = args.seconds or bm["run_seconds"]
    failed_all = True
    for seed in args.seeds:
        readings = harness.driver(mix["kind"]).control(
            cfg=cfg, mix=mix, seed=seed, device="cuda:0",
            seconds=seconds)
        correct, checks = judge.decide(readings, limits)
        failed_all = failed_all and not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": checks}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
