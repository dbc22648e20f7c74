"""Find the serving knee once: run a serve cell's mix at several fixed
rates, one window each, and print the latency of each.

    python3 bench/sweep.py --workload <serve cell> --seed <n> \
        --seconds <s> --rates <q/s> [<q/s> ...]

The knee is the highest rate whose p95 stays bounded and whose backlog
does not grow: the latency of the window's last fifth of queries stays
near that of its first fifth.  The cell's fixed rate is set once, at
about four fifths of it.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness
    from bench.kinds import serve
    bm = harness.load_benchmark()
    w = harness.workload(bm, args.workload)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    for rate in args.rates:
        out = serve.run(cfg=cfg, mix=mix, seed=args.seed,
                        seconds=args.seconds, trace=False, device="cuda:0",
                        t_start=time.perf_counter(),
                        limits=harness.limits(args.workload), rate=rate)
        lat = out["latencies_s"]
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_qps": rate, "correct": out["correct"],
            "p50_ms": out["log"]["p50_ms"], "p95_ms": out["log"]["p95_ms"],
            "max_ms": out["log"]["max_ms"], "late_ms": out["log"]["late_ms"],
            "refused": out["log"]["refused"],
            "first_fifth_median_ms": 1e3 * statistics.median(lat[:fifth]),
            "last_fifth_median_ms": 1e3 * statistics.median(lat[-fifth:])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
