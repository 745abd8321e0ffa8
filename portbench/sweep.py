"""The rate sweep that a serving cell's rate was set from: the cell's
traffic at each of several fixed request rates, one process.

    python3 portbench/sweep.py --workload set3.serve --seconds 40 \
        --rates 7 8 9 10 11

Prints one JSON line a rate: latency p50 / p95 / p99 (ms), failed
requests, proteins per server pass, and the median latency of the first
and the last quarter of the requests (a last quarter far above the first
is a queue that grows: the rate is past what the server sustains).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=900)
    args = p.parse_args(argv)
    for k, rate in enumerate(args.rates):
        out = harness.run_cell(ROOT, args.workload, args.seed + k,
                               args.seconds, False, "cuda",
                               time.perf_counter(), traffic={"rate": rate})
        rec = out["record"]
        lat = np.asarray(rec["latencies_ms"], np.float64)
        q = max(len(lat) // 4, 1)
        print(json.dumps({
            "rate": rate, "correct": out["correct"], "requests": len(lat),
            "failed": rec["failed"],
            **{f"p{p}": float(np.percentile(lat, p)) for p in (50, 95, 99)},
            "first_quarter_p50": float(np.median(lat[:q])),
            "last_quarter_p50": float(np.median(lat[-q:])),
            "proteins_per_pass": rec["proteins_per_pass"],
            "client_late_max_ms": rec["notes"]["client_late_max_ms"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
