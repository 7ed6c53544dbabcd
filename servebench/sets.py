"""Sets of runs of one cell, one process each, and their spreads.

    python3 servebench/sets.py --workload <cell> --seconds S --seeds A B C ... [--sets 2] [--trace 0]
                               [--out FILE]

Runs ``run.py`` once a seed, in turn, ``--sets`` times over the same seeds,
and prints one JSON line a run (its result, exit code, wall seconds) and
then, for each metric, each set's median and spread (distance between the
quartiles over the median, ``statistics.quantiles(n=4)``) and the widest
spread: what a bound is set from.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from servebench.stats import spread  # noqa: E402


def one_run(workload, seed, seconds, trace):
    t = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "rc": p.returncode, "wall_s": time.perf_counter() - t, "result": result,
            "stderr_tail": p.stderr[-2000:] if p.returncode or result is None or not result["correct"] else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    sets = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            emit({"workload": args.workload, "set": s, **r})
            runs.append(r)
        sets.append(runs)
    summary = {}
    names = sorted({k for runs in sets for r in runs if r["result"] for k in r["result"]["metrics"]})
    for name in names:
        per = []
        for runs in sets:
            vals = [r["result"]["metrics"][name]["value"] for r in runs if r["result"] and name in r["result"]["metrics"]]
            if len(vals) >= 2 and statistics.median(vals):
                per.append({"median": statistics.median(vals), "spread": spread(vals), "values": vals})
        if per:
            summary[name] = {"sets": per, "widest_spread": max(p["spread"] for p in per)}
    emit({"workload": args.workload, "summary": summary,
          "correct": [r["result"]["correct"] if r["result"] else None for runs in sets for r in runs]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
