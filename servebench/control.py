"""Readings that set a cell's limits: the program's and the control's.

    python3 servebench/control.py --workload <cell> --seeds 11 12 13 --seconds S [--out FILE]

For each seed, in one process: one run of the cell as ``run.py`` makes it
(set-up, a window of ``S`` seconds at the cell's own load, the comparison),
then the control on the same sample: the reference one precision step below
the configuration (``precision="control"``), read by the token it puts
first at each position and judged under the configuration's limits. Prints
one JSON line a seed: the program's numbers (``check``), the control's
(``control``), ``correct``, ``control_correct`` and the end-to-end metrics.
Exits with code 1 when the control passed on any seed: a comparison that
cannot fail its control decides nothing. The benchmark's own runs never run
the control.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("servebench control: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from servebench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    passed = []
    for seed in args.seeds:
        t = time.perf_counter()
        result, _ = harness.run_cell(bench, args.workload, seed, args.seconds, False, t, control=True)
        if result["control_correct"]:
            passed.append(seed)
            print(f"servebench control: seed {seed}: the control passes the limits "
                  f"{result['control_check']}: the comparison cannot tell it from the program",
                  file=sys.stderr, flush=True)
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                           "check": {k: v["value"] for k, v in result["check"].items()},
                           "control": result["control"], "control_correct": result["control_correct"],
                           "attempted": result["attempted"],
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                           "run_s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del result
        gc.collect()
        torch.cuda.empty_cache()
    if passed:
        print(f"servebench control: the control passed on seeds {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
