"""Serving benchmark of hpc_ops_tpu_torch: one run of one cell.

    python3 servebench/run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1

Run from the root of a checkout. Prints the result as one JSON line, last
on standard output, after the numbers compared beside their limits on
standard error. Needs a CUDA card: without one it exits with code 2 and
prints no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every cache a library might keep goes to a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "servebench", sub)
os.environ["USE_FLAX"] = "0"  # transformers, if anything loads it, leaves JAX alone
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"servebench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"servebench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from servebench import harness

    try:
        result, lines = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                         T_PROCESS)
    except harness.ForbiddenModules as e:
        print(f"servebench: the measuring process loaded {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
