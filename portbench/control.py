"""Readings that a cell's limits are set from, on many seeds in one
process: each seed's run with the control (the reference in TF32) put in
the program's place, judged by the cell's own checks, which has to come
out not correct; and, from the same run, the program's widest score gap
against the plain reference.

    python3 portbench/control.py --workload <cell> --seconds 3 --seeds 1 2 3

Prints one JSON line a seed and a summary line. The benchmark's own runs
never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds:
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               args.device, time.perf_counter(), control=True)
        rec = out["record"]
        row = {"seed": seed, "control_correct": out["correct"],
               "attempted": rec["attempted"], "sampled": rec["sampled"],
               "control_checks": out["checks"],
               "program_gap": rec["program_gap"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    gaps = [r["program_gap"] for r in rows]
    controls = [r["control_checks"]["score_gap"]["value"] for r in rows]
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "control_correct_any": any(
                          r["control_correct"] for r in rows),
                      "program_max": max(gaps), "program_all": gaps,
                      "control_min": min(controls),
                      "control_all": controls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
